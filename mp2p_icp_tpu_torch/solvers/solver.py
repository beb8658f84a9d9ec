"""Solver modules with gating, for the ICP loop.

Port of ``SolverHorn`` and ``SolverGaussNewton`` from
``mp2p_icp_tpu/solvers/solver.py`` (reference: Solver.h:43-102): gating by
``enabled`` and the iteration window; the
``run_until_translation_correction_smaller_than`` latch lives in
``ICP._run_solvers``. Horn converts pt2ln/pt2pl to virtual pt2pt first
(Solver_Horn.cpp:41-61). ``SolverOLAE`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from mp2p_icp_tpu_torch.core.pairings import Pairings
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.matchers.base import static_value
from mp2p_icp_tpu_torch.solvers.common import WeightParameters
from mp2p_icp_tpu_torch.solvers.gauss_newton import (
    GNParams,
    SE3Prior,
    optimal_tf_gauss_newton,
)
from mp2p_icp_tpu_torch.solvers.horn import optimal_tf_horn
from mp2p_icp_tpu_torch.solvers.pt2_conversions import pt2ln_pl_to_pt2pt


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
    # reporting-only optimal scale (ICPResults.optimal_scale); not ported yet
    estimate_scale: bool = False

    def __post_init__(self):
        if self.estimate_scale:
            raise NotImplementedError(
                "SolverHorn(estimate_scale=True) is not ported yet"
            )

    def solve(self, pairings: Pairings, guess: Pose,
              prior: Optional[SE3Prior] = None, iteration=None) -> Pose:
        p = pt2ln_pl_to_pt2pt(pairings, guess)
        return optimal_tf_horn(p, self.weight_params, current_estimate=guess)


@dataclasses.dataclass(frozen=True)
class SolverGaussNewton(Solver):
    """Reference: Solver_GaussNewton.cpp:29-67."""

    gn_params: GNParams = dataclasses.field(default_factory=GNParams)

    def solve(self, pairings: Pairings, guess: Pose,
              prior: Optional[SE3Prior] = None, iteration=None) -> Pose:
        static_value(self.gn_params.kernel_param, "kernel_param")
        return optimal_tf_gauss_newton(pairings, guess, self.gn_params, prior)
