"""Batched registration: B independent ICP problems in one loop.

Port of ``mp2p_icp_tpu/parallel/batch.py``. The JAX package runs
``jax.vmap`` over its fused align program. Here one host loop runs every
ICP iteration for all problems with ``torch.func.vmap`` over ``ICP._step``
(matchers, solvers, termination flags): every ported module runs as it is,
and each kNN sweep of the iteration is one launch of the batched kernel for
all problems (the vmap rule of the sweep operator, ``ops/nn_bruteforce``).

Semantics are those of ``vmap`` over a ``while_loop``:

- the module windows depend only on the iteration, so they are shared;
- each problem keeps its own running flag; a problem that has stopped
  keeps its pose, pairings and iteration count while the others run on;
- the loop ends when no problem runs; the iteration's one host sync reads
  that flag;
- each problem crops the (possibly shared) global map at its own guess,
  so after a crop both sides of the sweep are batched.

Not supported yet, and raising ``NotImplementedError``: solvers with the
``run_until_translation_correction_smaller_than`` latch (it reads the step
on the host), quality evaluators that run their own matcher, and the
options ``ICP.align`` does not support either.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.utils._pytree as pytree
from torch.func import vmap

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.covariance import covariance as compute_covariance
from mp2p_icp_tpu_torch.icp import (
    ICP,
    ICPParameters,
    ICPResults,
    IterTermReason,
    quality_checkpoints,
)
from mp2p_icp_tpu_torch.matchers.base import point_layers

_RUNNING = int(IterTermReason.UNDEFINED)


def make_batched_align(icp: ICP, params: ICPParameters = None,
                       broadcast_globals: bool = False):
    """Returns ``fn(batched_local_layers, batched_global_layers,
    batched_guess) -> batched ICPResults`` (the argument order of
    ``ICP.align``). Every input carries a leading batch axis: layers are
    ``PointCloud`` s with xyz [B, C, 3] and count [B] (``stack_pytrees``),
    the guess a ``Pose`` of [B, 3, 3] and [B, 3].

    ``broadcast_globals=True`` shares ONE unbatched global map (the plain
    layer dict) across the batch: B scans localise against the same map,
    each with its own crop, without B copies of it.

    The results carry a leading B: ``n_iterations`` and
    ``termination_reason`` are [B] int32 tensors."""
    params = params or ICPParameters()
    icp._check_options(params)
    for s in icp.solvers:
        if s.run_until_translation_correction_smaller_than > 0:
            raise NotImplementedError(
                "batched align: run_until_translation_correction_smaller_than "
                "is not supported yet"
            )
    for ev in icp.quality_evaluators:
        if not getattr(ev, "reuse_icp_pairings", True) and ev.matcher is not None:
            raise NotImplementedError(
                "batched align: quality evaluators with their own matcher are "
                "not supported yet"
            )

    def run(local_map, global_map, guess: Pose) -> ICPResults:
        l_layers, g_layers = point_layers(local_map), point_layers(global_map)
        _check_batched(l_layers, g_layers, guess, broadcast_globals)
        g_layers, gidx_maps, g_dim = crop_batched(
            icp, params, g_layers, l_layers, guess, None if broadcast_globals else 0)
        return _align_batched(icp, params, l_layers, g_layers, guess, gidx_maps, g_dim)

    return run


def stack_pytrees(trees):
    """Stack a list of identically-shaped pytrees (layer dicts, poses)
    along a new leading axis."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _where(mask: torch.Tensor, new, old):
    """Per problem: leaves of ``new`` where mask [B] is set, else ``old``."""
    return pytree.tree_map(
        lambda a, b: torch.where(mask.view(-1, *([1] * (a.ndim - 1))), a, b), new, old
    )


def _check_batched(l_layers: Dict[str, PointCloud], g_layers: Dict[str, PointCloud],
                   guess: Pose, broadcast: bool):
    if not g_layers or not l_layers:
        raise ValueError("empty input maps")
    B = guess.t.shape[0]
    for name, layer in l_layers.items():
        if layer.xyz.ndim != 3 or layer.xyz.shape[0] != B:
            raise ValueError(f"local layer {name!r} must be batched [B={B}, C, 3]")
    for name, layer in g_layers.items():
        if layer.xyz.ndim != (2 if broadcast else 3) or (
                not broadcast and layer.xyz.shape[0] != B):
            raise ValueError(
                f"global layer {name!r} must be "
                f"{'one [C, 3] map' if broadcast else f'batched [B={B}, C, 3]'}")



def crop_batched(icp: ICP, params: ICPParameters, g_layers, l_layers, guess: Pose, g_dim=0):
    """``ICP._crop_globals`` for every problem at its own guess. ``g_dim``
    is 0 for batched global layers and None for one shared map. Returns
    (layers, index maps, g_dim of the returned layers): after a crop the
    layers are batched; without one they come back as they are."""
    if not icp._crop_layers(params, g_layers):
        return g_layers, {}, g_dim
    g_layers, gidx_maps = vmap(
        lambda g, l, pose: icp._crop_globals(params, g, l, pose),
        in_dims=(g_dim, 0, 0),
    )(g_layers, l_layers, guess)
    return g_layers, gidx_maps, 0


def _align_batched(icp: ICP, params: ICPParameters, l_layers: Dict[str, PointCloud],
                   g_layers: Dict[str, PointCloud], guess: Pose, gidx_maps: dict, g_dim=0):
    """The batched ICP loop on global layers that are already cropped
    (``crop_batched``; the fleet odometry step crops once and keeps the crop
    as the candidate pool of its normals fit)."""
    B = guess.t.shape[0]
    device = guess.t.device
    checkpoints = quality_checkpoints(params)
    finished = [False] * len(icp.solvers)  # no latch in the batched loop
    one = Pose(guess.R[0], guess.t[0])
    pairings = pytree.tree_map(  # empty pairings with the full layout
        lambda x: x.expand(B, *x.shape),
        icp._run_matchers([False] * len(icp.matchers), g_layers, l_layers, one, 0),
    )
    pose = prev_pose = guess
    reason = torch.full((B,), _RUNNING, dtype=torch.int32, device=device)
    running = reason == _RUNNING
    n_iter = torch.zeros(B, dtype=torch.int32, device=device)

    for iteration in range(params.max_iterations):
        m_active = [m.gate(iteration) > 0 for m in icp.matchers]
        s_active = [s.gate(iteration) for s in icp.solvers]

        def step(g, l, p, prev, maps):
            return icp._step(params, None, iteration, m_active, s_active, finished,
                             g, l, p, prev, maps)[:5]

        new_pairs, new_pose, no_pairs, solver_ok, stalled = vmap(
            step, in_dims=(g_dim, 0, 0, 0, 0))(g_layers, l_layers, pose, prev_pose,
                                               gidx_maps)
        prev_pose, pose = (_where(running, pose, prev_pose),
                           _where(running & solver_ok & ~no_pairs, new_pose, pose))
        pairings = _where(running, new_pairs, pairings)
        n_iter = n_iter + running.to(torch.int32)
        step_reason = torch.where(
            no_pairs, int(IterTermReason.NO_PAIRINGS),
            torch.where(~solver_ok, int(IterTermReason.SOLVER_ERROR),
                        torch.where(stalled, int(IterTermReason.STALLED), _RUNNING)),
        ).to(torch.int32)
        reason = torch.where(running, step_reason, reason)
        if iteration + 1 in checkpoints:
            q = vmap(lambda pr, g, l, p: icp._quality_stack(pr, g, l, p, iteration + 1),
                     in_dims=(0, g_dim, 0, 0))(pairings, g_layers, l_layers, pose)
            fail = (reason == _RUNNING) & (q < checkpoints[iteration + 1])
            reason = torch.where(
                fail, int(IterTermReason.QUALITY_CHECKPOINT_FAILED), reason
            ).to(torch.int32)
        running = reason == _RUNNING
        if not bool(running.any()):  # the iteration's one host sync
            break

    reason = torch.where(running, int(IterTermReason.MAX_ITERATIONS), reason).to(torch.int32)
    # the final quality reads no iteration-dependent state (evaluators with
    # their own matcher are refused above)
    quality = vmap(lambda pr, g, l, p: icp._quality_stack(pr, g, l, p, 0),
                   in_dims=(0, g_dim, 0, 0))(pairings, g_layers, l_layers, pose)
    return ICPResults(
        optimal_tf=pose,
        optimal_scale=torch.ones(B, device=device),
        n_iterations=n_iter,
        termination_reason=reason,
        quality=quality,
        final_pairings=pairings,
        covariance=vmap(compute_covariance)(pairings, pose),
    )
