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
  so after a crop both sides of the sweep are batched;
- ``Expression`` fields take the shared iteration; the
  ``run_until_translation_correction_smaller_than`` latch is a per-problem
  tensor (``ICP._run_solvers`` decides it on the device);
- the final quality is evaluated at each problem's own final iteration,
  and a quality evaluator with its own matcher runs that matcher under
  vmap (its kNN is one batched launch);
- records, the hook and the optimal scale are per problem. As in the JAX
  package, a batch writes no debug files;
- over a data x space mesh (``make_batched_align(..., space=mesh.space)``) each rank
  runs this loop on its rows against its shard of their maps; the one
  host read of an iteration agrees across a ``space`` group because the
  merged pairings, and so every decision, are the same on its ranks.
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
    stack_records,
)
from mp2p_icp_tpu_torch.matchers.base import point_layers
from mp2p_icp_tpu_torch.parallel.spatial import spatial_icp
from mp2p_icp_tpu_torch.utils.profiler import profile_scope

_RUNNING = int(IterTermReason.UNDEFINED)


def make_batched_align(icp: ICP, params: ICPParameters = None,
                       broadcast_globals: bool = False, space=None):
    """Returns ``fn(batched_local_layers, batched_global_layers,
    batched_guess) -> batched ICPResults`` (the argument order of
    ``ICP.align``). Every input carries a leading batch axis: layers are
    ``PointCloud`` s with xyz [B, C, 3] and count [B] (``stack_pytrees``),
    the guess a ``Pose`` of [B, 3, 3] and [B, 3].

    ``broadcast_globals=True`` shares ONE unbatched global map (the plain
    layer dict) across the batch: B scans localise against the same map,
    each with its own crop, without B copies of it.

    The results carry a leading B: ``n_iterations`` and
    ``termination_reason`` are [B] int32 tensors.

    ``space``: the ``space`` axis (a ``parallel.mesh.MeshAxis``) of a data
    x space mesh, which splits every problem's global map over its ranks
    (the JAX package's data x space placement). Every rank of a ``space`` group calls ``fn`` with the same
    rows (``mesh.shard_batch`` / ``multihost.host_local_batch``) and its own
    shard of their maps (``spatial.own_shard``; with ``broadcast_globals``
    one shard of the shared map). The matchers, and the own matcher of a
    quality evaluator, sweep the shards (one K2 launch per call for all the
    rows) and merge the k-lists with one all_gather over ``space`` for the
    whole batch (``ops/nn_bruteforce.knn_sharded``); each shard is cropped
    at each problem's guess and the crop's index maps are dropped, so
    recorded global ids address the cropped shards, the same on every rank.
    Every rank of the group ends with the same results, equal to the
    unsharded batch's where no shard's crop overflows (``make_spatial_align``
    states the same); ``multihost.fetch_replicated(x, mesh)`` gathers the
    rows over ``data``. Collectives never cross ``data`` inside the loop."""
    params = params or ICPParameters()
    icp._check_options(params)
    sharded = space is not None and space.size > 1
    if sharded:
        icp = spatial_icp(icp, space)

    def run(local_map, global_map, guess: Pose) -> ICPResults:
        l_layers, g_layers = point_layers(local_map), point_layers(global_map)
        _check_batched(l_layers, g_layers, guess, broadcast_globals)
        g_layers, gidx_maps, g_dim = crop_batched(
            icp, params, g_layers, l_layers, guess, None if broadcast_globals else 0)
        if sharded:
            gidx_maps = {}
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
    l_layers = {k: v for k, v in l_layers.items() if isinstance(v, PointCloud)}
    g_layers = {k: v for k, v in g_layers.items() if isinstance(v, PointCloud)}
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
    finished = torch.zeros(B, len(icp.solvers), dtype=torch.bool, device=device)
    one = Pose(guess.R[0], guess.t[0])
    pairings = pytree.tree_map(  # empty pairings with the full layout
        lambda x: x.expand(B, *x.shape),
        icp._run_matchers([False] * len(icp.matchers), g_layers, l_layers, one, 0),
    )
    pose = prev_pose = guess
    reason = torch.full((B,), _RUNNING, dtype=torch.int32, device=device)
    running = reason == _RUNNING
    n_iter = torch.zeros(B, dtype=torch.int32, device=device)
    records = [] if params.record_iterations else None

    for iteration in range(params.max_iterations):
        with profile_scope("icp.iter"):
            m_active = [m.gate(iteration) > 0 for m in icp.matchers]
            s_active = [s.gate(iteration) for s in icp.solvers]

            def step(g, l, p, prev, maps, fin):
                return icp._step(params, None, iteration, m_active, s_active, fin,
                                 g, l, p, prev, maps)

            new_pairs, new_pose, no_pairs, solver_ok, stalled, new_fin = vmap(
                step, in_dims=(g_dim, 0, 0, 0, 0, 0))(g_layers, l_layers, pose, prev_pose,
                                                      gidx_maps, finished)
            # each problem's own stop, after ICP._step's flags
            with profile_scope("icp.terminate"):
                prev_pose, pose = (_where(running, pose, prev_pose),
                                   _where(running, new_pose, pose))
                pairings = _where(running, new_pairs, pairings)
                finished = _where(running, new_fin, finished)
                n_iter = n_iter + running.to(torch.int32)
                step_reason = torch.where(
                    no_pairs, int(IterTermReason.NO_PAIRINGS),
                    torch.where(~solver_ok, int(IterTermReason.SOLVER_ERROR),
                                torch.where(stalled, int(IterTermReason.STALLED), _RUNNING)),
                ).to(torch.int32)
                if params.iteration_hook is not None:
                    stop = vmap(lambda R, t, n: torch.as_tensor(
                        params.iteration_hook(iteration, R, t, n), dtype=torch.bool,
                        device=device))(
                            new_pose.R, new_pose.t, vmap(lambda pr: pr.size())(new_pairs))
                    step_reason = torch.where((step_reason == _RUNNING) & stop,
                                              int(IterTermReason.HOOK_REQUEST), step_reason)
                reason = torch.where(running, step_reason, reason).to(torch.int32)
            if iteration + 1 in checkpoints:
                with profile_scope("icp.quality"):
                    q = vmap(lambda pr, g, l, p: icp._quality_stack(pr, g, l, p, iteration + 1),
                             in_dims=(0, g_dim, 0, 0))(pairings, g_layers, l_layers, pose)
                    fail = (reason == _RUNNING) & (q < checkpoints[iteration + 1])
                    reason = torch.where(
                        fail, int(IterTermReason.QUALITY_CHECKPOINT_FAILED), reason
                    ).to(torch.int32)
            if records is not None:
                records.append((pose, vmap(lambda pr: pr.size())(pairings),
                                vmap(lambda pr: pr.decimated(params.record_pairings_capacity))(
                                    pairings) if params.record_pairings else None))
            running = reason == _RUNNING
            any_running = running.any()
            with profile_scope("sync.batch_running"):  # the iteration's one host sync
                any_running = bool(any_running)
            if not any_running:
                break

    reason = torch.where(running, int(IterTermReason.MAX_ITERATIONS), reason).to(torch.int32)
    recorded = {}
    if records:
        # the iteration axis second: [B, max_iterations, ...]; stopped
        # problems repeat their final state, as every problem does after
        # the loop ends
        records += [records[-1]] * (params.max_iterations - len(records))
        recorded = pytree.tree_map(lambda x: x.movedim(0, 1), stack_records(records))
    with profile_scope("icp.results"):
        # each problem's quality at its own final iteration (JAX icp.py:762-765)
        quality = vmap(icp._quality_stack, in_dims=(0, g_dim, 0, 0, 0))(
            pairings, g_layers, l_layers, pose, n_iter)
        return ICPResults(
            optimal_tf=pose,
            optimal_scale=vmap(icp._optimal_scale)(pairings, pose),
            n_iterations=n_iter,
            termination_reason=reason,
            quality=quality,
            final_pairings=pairings,
            covariance=vmap(compute_covariance)(pairings, pose),
            **recorded,
        )
