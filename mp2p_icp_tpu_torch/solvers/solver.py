"""Solver modules with gating, for the ICP loop.

Port of ``SolverHorn`` and ``SolverGaussNewton`` from
``mp2p_icp_tpu/solvers/solver.py`` (reference: Solver.h:43-102): gating by
``enabled`` and the iteration window; the
``run_until_translation_correction_smaller_than`` latch lives in
``ICP._run_solvers``. Horn converts pt2ln/pt2pl to virtual pt2pt first
(Solver_Horn.cpp:41-61), and so does OLAE.

The solvers compute in float64 and return a float32 pose (the JAX
package solves in float32). Scan-to-map poses sit hundreds of metres from
the origin, where one float32 step is ~3e-5 m, so float32 sums over
thousands of pairs round differently with the summation order: a batched
solve (parallel.batch) would drift from the sequential one by a few ulps
each iteration, enough to flip a pair at the distance threshold. Summed in
float64 and rounded once, both give the same float32 pose.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.core.pairings import Pairings
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.matchers.base import static_value
from mp2p_icp_tpu_torch.solvers.common import WeightParameters
from mp2p_icp_tpu_torch.solvers.gauss_newton import (
    GNParams,
    SE3Prior,
    optimal_tf_gauss_newton,
)
from mp2p_icp_tpu_torch.solvers.horn import horn_scale, optimal_tf_horn
from mp2p_icp_tpu_torch.solvers.olae import optimal_tf_olae
from mp2p_icp_tpu_torch.solvers.pt2_conversions import pt2ln_pl_to_pt2pt


def f64(tree):
    """A pytree with its floating-point tensors in float64."""
    return pytree.tree_map(
        lambda x: x.double() if isinstance(x, torch.Tensor) and x.is_floating_point()
        else x, tree)


def solve_in_f64(solve: Callable, pairings: Pairings, guess: Pose,
                 prior: Optional[SE3Prior] = None) -> Pose:
    """``solve(pairings, guess, prior)`` on float64 copies of its inputs,
    with the resulting pose rounded back to the guess's dtype."""
    prior64 = (None if prior is None
               else SE3Prior(mean=f64(prior.mean), inv_cov=prior.inv_cov.double()))
    out = solve(f64(pairings), f64(guess), prior64)
    return Pose(out.R.to(guess.R.dtype), out.t.to(guess.t.dtype))


@dataclasses.dataclass(frozen=True)
class Solver:
    enabled: bool = True
    run_from_iteration: int = 0
    run_up_to_iteration: int = 0  # 0 = unbounded
    run_until_translation_correction_smaller_than: float = 0.0

    def gate(self, iteration: int) -> bool:
        """Static iteration-window gate (Solver.cpp:40-42)."""
        on = self.enabled and iteration >= self.run_from_iteration
        if self.run_up_to_iteration > 0:
            on = on and iteration <= self.run_up_to_iteration
        return on


@dataclasses.dataclass(frozen=True)
class SolverHorn(Solver):
    """Reference: Solver_Horn.cpp:41-61."""

    weight_params: WeightParameters = dataclasses.field(
        default_factory=WeightParameters
    )
    # fill ICPResults.optimal_scale from the final pairings (horn_scale);
    # reporting only, the solved pose stays rigid
    estimate_scale: bool = False

    def solve(self, pairings: Pairings, guess: Pose,
              prior: Optional[SE3Prior] = None, iteration=None) -> Pose:
        def horn(pairings, guess, prior):
            p = pt2ln_pl_to_pt2pt(pairings, guess)
            return optimal_tf_horn(p, self.weight_params, current_estimate=guess)

        return solve_in_f64(horn, pairings, guess)

    def scale(self, pairings: Pairings, pose: Pose) -> torch.Tensor:
        """``horn_scale`` of the pairings at ``pose`` (pt2ln/pt2pl
        converted), summed in float64 and rounded to the pose's dtype."""
        return horn_scale(pt2ln_pl_to_pt2pt(f64(pairings), f64(pose)),
                          self.weight_params).to(pose.t.dtype)


@dataclasses.dataclass(frozen=True)
class SolverOLAE(Solver):
    """Reference: Solver_OLAE (pt2ln/pt2pl converted as for Horn)."""

    weight_params: WeightParameters = dataclasses.field(
        default_factory=WeightParameters
    )

    def solve(self, pairings: Pairings, guess: Pose,
              prior: Optional[SE3Prior] = None, iteration=None) -> Pose:
        def olae(pairings, guess, prior):
            p = pt2ln_pl_to_pt2pt(pairings, guess)
            return optimal_tf_olae(p, self.weight_params, current_estimate=guess)

        return solve_in_f64(olae, pairings, guess)


@dataclasses.dataclass(frozen=True)
class SolverGaussNewton(Solver):
    """Reference: Solver_GaussNewton.cpp:29-67."""

    gn_params: GNParams = dataclasses.field(default_factory=GNParams)

    def solve(self, pairings: Pairings, guess: Pose,
              prior: Optional[SE3Prior] = None, iteration=None) -> Pose:
        # kernel_param may be an Expression over ICP_ITERATION
        gp = dataclasses.replace(self.gn_params, kernel_param=static_value(
            self.gn_params.kernel_param, "kernel_param", iteration or 0))
        return solve_in_f64(
            lambda p, g, pr: optimal_tf_gauss_newton(p, g, gp, pr),
            pairings, guess, prior)
