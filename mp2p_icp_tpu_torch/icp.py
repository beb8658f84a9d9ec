"""The ICP orchestrator.

Port of ``mp2p_icp_tpu/icp.py`` (reference: ICP.cpp:36-382 ``ICP::align``):
the matcher -> solver -> termination -> quality pipeline with per-iteration
module windows, first-wins solvers with the
``run_until_translation_correction_smaller_than`` latch, step-size and
oscillation stall detection, quality checkpoints, and the final quality and
covariance; and the crop of global layers above ``crop_capacity`` to the
box around the local scan at the guess (scan-to-large-map localisation).

The JAX package compiles the loop into one ``lax.while_loop`` per schedule
segment. Here the loop is a plain Python loop: each iteration picks its
active matchers and solvers on the host (the same windows), runs them on the
device of the input tensors (``ICP._step``), and reads the termination
flags (and the hook's answer) back with one host sync. ``parallel.batch``
runs the same step under ``torch.func.vmap`` for a batch of problems.

Also as in the JAX package: per-iteration records (``record_iterations``,
``record_pairings``; after termination the rows repeat the final state, so
there are always ``max_iterations`` of them), the per-iteration hook, the
optimal scale of a ``SolverHorn(estimate_scale=True)``, and the debug log
files (``io/debug_dump.py``). A map is a ``{name: layer}`` dict or a
``MetricMap``: matchers and the crop use its point layers; the quality
evaluators see what the JAX package gives them (all layers of a dict, the
point layers of a MetricMap).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.core.pairings import BLOCK_TYPES, Pairings, concat_blocks
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.covariance import covariance as compute_covariance
from mp2p_icp_tpu_torch.io.debug_dump import save_icp_debug_file
from mp2p_icp_tpu_torch.matchers.base import (
    MatchContext,
    MatchState,
    point_layers,
    spatial_scale,
    transformed_local,
)
from mp2p_icp_tpu_torch.ops import icp_terminate
from mp2p_icp_tpu_torch.quality.paired_ratio import QualityPairedRatio
from mp2p_icp_tpu_torch.solvers.gauss_newton import SE3Prior
from mp2p_icp_tpu_torch.utils.profiler import profile_scope, spanned


class IterTermReason(enum.IntEnum):
    """Reference: mp2p_icp/include/mp2p_icp/IterTermReason.h."""

    UNDEFINED = 0
    NO_PAIRINGS = 1
    SOLVER_ERROR = 2
    MAX_ITERATIONS = 3
    STALLED = 4
    HOOK_REQUEST = 5
    QUALITY_CHECKPOINT_FAILED = 6


_RUNNING = IterTermReason.UNDEFINED  # while the loop is live
_BIG = 3.0e37


@dataclasses.dataclass(frozen=True)
class ICPParameters:
    """Reference: mp2p_icp/include/mp2p_icp/Parameters.h:34-106."""

    max_iterations: int = 40
    min_abs_step_trans: float = 5e-4
    min_abs_step_rot: float = 1e-4
    # (iteration, min quality) pairs; reference default {50:0.05, 100:0.10}
    quality_checkpoints: Tuple[Tuple[int, float], ...] = ((50, 0.05), (100, 0.10))
    # scan-to-large-map: a matcher-referenced global layer above
    # crop_capacity points is cropped, once at the guess, to the box around
    # the transformed local layers grown by the matchers' search radius plus
    # crop_extra_margin (None = crop when it shrinks the layer, False = off)
    crop_to_local_bbox: Optional[bool] = None
    crop_capacity: int = 131072
    crop_extra_margin: float = 5.0
    # print each iteration's pairings and pose on the host (a host read per
    # iteration while on)
    debug_print_iteration_progress: bool = False
    # per-iteration poses and pair counts (reference: LogRecord
    # iterationsDetails, LogRecord.h:58-71), and with record_pairings a
    # decimated Pairings per iteration (record_pairings_capacity rows per
    # block; the reference keeps the full Pairings)
    record_iterations: bool = False
    record_pairings: bool = False
    record_pairings_capacity: int = 512
    # hook(iteration, R, t, n_pairings) -> bool, called after each step on
    # the pose it keeps; True ends the align with HOOK_REQUEST (reference:
    # ICP.cpp:286-303). It gets tensors on the device and may return a bool
    # or a 0-d tensor: it is read with the iteration's termination flags
    iteration_hook: Optional[Callable] = None
    # debug log files (reference: Parameters.h:66-96, ICP.cpp:384-467):
    # every align writes an .icplog.npz record named from the template
    generate_debug_files: bool = False
    # store the per-iteration records in the file (turns on
    # record_iterations and record_pairings)
    save_iteration_details: bool = False
    decimation_iteration_details: int = 10  # keep 1 of N recorded iterations
    decimation_debug_files: int = 1  # write 1 of N files
    # $UNIQUE_ID / $GLOBAL_ID / $GLOBAL_LABEL / $LOCAL_ID / $LOCAL_LABEL
    debug_file_name_format: str = (
        "icp-run-$UNIQUE_ID-local-$LOCAL_ID$LOCAL_LABEL-"
        "global-$GLOBAL_ID$GLOBAL_LABEL.icplog.npz"
    )
    # applied to each map before it is written; may return a replacement
    functor_before_logging_local: Optional[Callable] = None
    functor_before_logging_global: Optional[Callable] = None


class ICPResults(NamedTuple):
    """Reference: mp2p_icp/include/mp2p_icp/Results.h:29-58."""

    optimal_tf: Pose
    # horn_scale of the final pairings when a SolverHorn(estimate_scale=True)
    # is enabled, else 1 (reporting only: the pose stays rigid)
    optimal_scale: torch.Tensor
    n_iterations: int
    termination_reason: IterTermReason
    quality: torch.Tensor
    final_pairings: Pairings
    covariance: torch.Tensor  # [6, 6]
    # with record_iterations: [max_iterations] rows each
    iteration_poses: Optional[Pose] = None
    iteration_pair_counts: Optional[torch.Tensor] = None
    iteration_pairings: Optional[Pairings] = None  # with record_pairings


@dataclasses.dataclass
class ICP:
    """Module container + align() entry point (reference: ICP.h:59-257)."""

    matchers: Sequence = ()
    solvers: Sequence = ()
    quality_evaluators: Sequence = (QualityPairedRatio(),)
    quality_weights: Sequence = None

    def __post_init__(self):
        if not self.quality_weights:
            self.quality_weights = [1.0] * len(self.quality_evaluators)

    # ------------------------------------------------------------- matchers
    def _run_matchers(self, active, g_layers, l_layers, pose, iteration,
                      gidx_maps=None):
        """Run the iteration's active matchers and concatenate their blocks
        into one Pairings (reference: run_matchers, Matcher.cpp:35-87).
        Inactive matchers contribute empty blocks of the same capacity, so
        the Pairings layout is the same on every iteration, and so is its
        ``live`` set: the block types of every matcher's ``out_blocks``.
        The paired masks are only kept when several matchers run together.
        ``gidx_maps``: the crop's index maps (see _crop_globals)."""
        device = pose.t.device
        # on a map split over ranks the global masks span every shard
        scale = max(spatial_scale(m) for m in self.matchers)
        state = MatchState.create(l_layers, g_layers, scale) if sum(active) > 1 else None
        ctx = MatchContext(icp_iteration=iteration,
                           global_index_maps=gidx_maps)
        acc: Dict[str, list] = {k: [] for k in BLOCK_TYPES}
        potential = torch.zeros((), dtype=torch.int32, device=device)
        for m, on in zip(self.matchers, active):
            if on:
                blocks, state, pot = m.match(g_layers, l_layers, pose, state, ctx)
                potential = potential + pot
            else:
                blocks = {
                    name: BLOCK_TYPES[name].empty(cap, device)
                    for name, cap in m.out_blocks(l_layers).items()
                }
            for k, v in blocks.items():
                acc[k].append(v)
        return Pairings(
            **{k: concat_blocks(acc[k], cls, device) for k, cls in BLOCK_TYPES.items()},
            potential_pairings=potential,
            live=frozenset(k for k, blocks in acc.items() if blocks),
        )

    # -------------------------------------------------------------- solvers
    def _run_solvers(self, pairings, pose, prev_pose, iteration, prior,
                     active, finished):
        """First enabled solver wins (reference: ICP::run_solvers,
        ICP.cpp:469-479). A solver with
        run_until_translation_correction_smaller_than > 0 runs until the
        last ICP step's translation norm |t_i - t_{i-1}| (unset on the first
        iteration) drops below it; a persistent per-solver latch
        (``finished``, [n_solvers] bool on the device) then hands off to the
        next solver for good (Solver.cpp:44-60). The latch is decided on the
        device: each solver that may run is solved and the winner picked
        with ``torch.where``, so there is no host read and the same code
        runs under ``torch.func.vmap``. Returns (new_pose, new_finished)."""
        act = [s for s, on in zip(self.solvers, active) if on]
        if not act:
            return pose, finished
        if not any(s.run_until_translation_correction_smaller_than > 0 for s in act):
            return act[0].solve(pairings, pose, prior, iteration=iteration), finished
        step_trans = torch.linalg.vector_norm(pose.t - prev_pose.t)
        new_finished = list(finished.unbind(-1))
        taken = torch.zeros((), dtype=torch.bool, device=pose.t.device)
        result = pose
        for i, (s, on) in enumerate(zip(self.solvers, active)):
            if not on:
                continue
            thr = s.run_until_translation_correction_smaller_than
            if thr > 0:
                # latch only when this solver is consulted (no earlier win)
                if iteration > 0:
                    new_finished[i] = finished[i] | (~taken & (step_trans < thr))
                run = ~taken & ~new_finished[i]
            else:
                run = ~taken
            sol = s.solve(pairings, pose, prior, iteration=iteration)
            result = Pose(torch.where(run, sol.R, result.R), torch.where(run, sol.t, result.t))
            taken = taken | run
            if thr <= 0:
                break  # this one runs whenever none before it did
        return result, torch.stack(new_finished, dim=-1)

    # ---------------------------------------------------------------- align
    def align(
        self,
        local_map,
        global_map,
        guess: Pose,
        params: Optional[ICPParameters] = None,
        prior: Optional[SE3Prior] = None,
    ) -> ICPResults:
        """Register local onto global starting from guess. Each map is a
        ``{name: layer}`` dict or a ``MetricMap``. Runs on the device of
        the input tensors."""
        params = params or ICPParameters()
        self._check_options(params)
        if params.generate_debug_files and params.save_iteration_details:
            # the reference stores the iteration details in the record
            # (Parameters.h:71-77): record them
            params = dataclasses.replace(params, record_iterations=True,
                                         record_pairings=True)
        g_layers = point_layers(global_map)
        l_layers = point_layers(local_map)
        for m in (g_layers, l_layers):
            if not isinstance(m, dict):
                raise TypeError(
                    f"a map is a dict of layers or a MetricMap, not {type(m).__name__}")
        if not g_layers or not l_layers:
            raise ValueError("empty input maps")
        for name, layer in list(g_layers.items()) + list(l_layers.items()):
            device = getattr(layer, "device", guess.t.device)
            if device != guess.t.device:
                raise ValueError(
                    f"layer {name!r} is on {device}, the guess on {guess.t.device}"
                )
        with profile_scope("icp.align"):  # the request's root span
            results = self._align_full(params, g_layers, l_layers, guess, prior)
            if params.generate_debug_files:
                save_icp_debug_file(params, local_map, global_map, guess, results)
        return results

    def _check_options(self, params):
        if not self.matchers or not self.solvers:
            raise ValueError("ICP requires at least one matcher and one solver")

    def _align_full(self, params, g_layers, l_layers, guess, prior):
        """Crop the large global layers at the guess, then run the loop."""
        g_layers, gidx_maps = self._crop_globals(params, g_layers, l_layers, guess)
        return self._align_core(params, g_layers, l_layers, guess, prior, gidx_maps)

    # ------------------------------------------------------------- cropping
    def _crop_layers(self, params, g_layers):
        """Names of the matcher-referenced global layers above
        ``crop_capacity`` (empty when cropping is off). Depends on shapes
        only."""
        if params.crop_to_local_bbox is False:
            return []
        used = {lm.global_layer for m in self.matchers for lm in m.layer_matches}
        return [n for n in sorted(used)
                if n in g_layers and g_layers[n].capacity > params.crop_capacity]

    @spanned("icp.crop")
    def _crop_globals(self, params, g_layers, l_layers, guess):
        """Compact each large matcher-referenced global layer to the points
        inside the box around the transformed local layers, grown by the
        matchers' search radius plus ``crop_extra_margin``, at a fixed
        ``crop_capacity`` (port of mp2p_icp_tpu/icp.py:427-508; the
        reference answers the same need with a lazy KD-tree over the map,
        metricmap.cpp:784-802). When more points are in the box than fit,
        an even stride over them keeps every stride-th one, so the kept set
        is spread over the box. Kept rows stay in map order.

        Returns (layers, index_maps): index_maps[name] is the
        [crop_capacity] i32 table from cropped row to the row of the user's
        map (-1 padding) for every cropped layer. The compaction is a
        cumsum rank and a scatter into an M+1 buffer (no argsort, no host
        sync), so it also runs under torch.func.vmap."""
        todo = self._crop_layers(params, g_layers)
        if not todo:
            return g_layers, {}
        M = params.crop_capacity
        out = dict(g_layers)
        index_maps = {}
        for name in todo:
            g = g_layers[name]
            N = g.capacity
            inside = self.in_crop_box(params, g, l_layers, guess)
            rank = torch.cumsum(inside, dim=0) - 1
            total = torch.sum(inside)
            stride = torch.clamp((total + M - 1) // M, min=1)
            inside = inside & (rank % stride == 0)
            rank = torch.cumsum(inside, dim=0) - 1
            count = torch.clamp(torch.sum(inside), max=M).to(torch.int32)
            # kept row r goes to slot rank[r] (< M); the rest to slot M
            slot = torch.where(inside & (rank < M), rank, M)
            order = torch.zeros(M + 1, dtype=torch.int64, device=g.device).scatter(
                0, slot, torch.arange(N, device=g.device))[:M]
            keep = torch.arange(M, device=g.device) < count

            def take(ch, fill):
                if ch is None:
                    return None
                k = keep if ch.ndim == 1 else keep[:, None]
                return torch.where(k, ch[order], fill)

            out[name] = PointCloud(
                xyz=take(g.xyz, PointCloud.PAD_VALUE),
                count=count,
                intensity=take(g.intensity, 0.0),
                ring=take(g.ring, 0.0),
                time=take(g.time, 0.0),
                normals=take(g.normals, 0.0),
            )
            index_maps[name] = torch.where(keep, order.to(torch.int32), -1)
        return out, index_maps

    def in_crop_box(self, params, g: PointCloud, l_layers, guess) -> torch.Tensor:
        """[C] bool: the valid rows of ``g`` inside the crop's box, the box
        around the transformed local layers the matchers read, grown by
        the matchers' largest search radius plus ``crop_extra_margin``."""
        margin = params.crop_extra_margin + max(
            (m.search_radius() for m in self.matchers), default=0.0
        )
        lnames = {lm.local_layer for m in self.matchers for lm in m.layer_matches}
        los, his = [], []
        for name in sorted(lnames):
            if name not in l_layers:
                continue
            pts, valid = transformed_local(l_layers[name], guess)
            los.append(torch.min(torch.where(valid[:, None], pts, _BIG), dim=0).values)
            his.append(torch.max(torch.where(valid[:, None], pts, -_BIG), dim=0).values)
        lo = torch.min(torch.stack(los), dim=0).values - margin
        hi = torch.max(torch.stack(his), dim=0).values + margin
        return g.valid_mask() & torch.all((g.xyz >= lo) & (g.xyz <= hi), dim=1)

    # ------------------------------------------------------------------ loop
    def _quality_stack(self, pairings, g_layers, l_layers, pose, iteration):
        """Weighted quality of all evaluators, 0 on a hard discard
        (reference: evaluate_quality, ICP.cpp:608-634)."""
        ctx = MatchContext(icp_iteration=iteration)
        q_acc = torch.zeros((), device=pose.t.device)
        w_acc = 0.0
        discard = torch.zeros((), dtype=torch.bool, device=pose.t.device)
        for ev, w in zip(self.quality_evaluators, self.quality_weights):
            qr = ev.evaluate(pairings, global_map=g_layers, local_map=l_layers,
                             pose=pose, ctx=ctx)
            q_acc = q_acc + w * qr.quality
            w_acc += w
            discard = discard | qr.hard_discard
        return torch.where(discard, 0.0, q_acc / max(w_acc, 1e-12))

    def _optimal_scale(self, pairings, pose):
        """``optimal_scale``: the first enabled SolverHorn(estimate_scale)'s
        scale of the final pairings, else 1 (JAX icp.py:769-785)."""
        for s in self.solvers:
            if getattr(s, "estimate_scale", False) and s.enabled:
                return s.scale(pairings, pose)
        return torch.ones((), device=pose.t.device)

    def _step(self, params, prior, iteration, m_active, s_active, finished,
              g_layers, l_layers, pose, prev_pose, gidx_maps):
        """One ICP iteration on the device, without host syncs: matchers,
        solvers, and the termination test (``ops/icp_terminate.py``: one
        kernel on the card). Returns (pairings, kept pose, flags, finished):
        flags is a bool [3], [no_pairs, solver_ok, stalled]; the kept pose
        is the solver's unless it failed or there were no pairs."""
        with profile_scope("icp.match"):
            pairings = self._run_matchers(m_active, g_layers, l_layers, pose,
                                          iteration, gidx_maps)
        with profile_scope("icp.solve"):
            new_pose, finished = self._run_solvers(
                pairings, pose, prev_pose, iteration, prior, s_active, finished
            )
        with profile_scope("icp.terminate"):
            pose_out, flags = icp_terminate.terminate(
                pairings, pose, prev_pose, new_pose, params.min_abs_step_trans,
                params.min_abs_step_rot)
        return pairings, pose_out, flags, finished

    def _align_core(self, params, g_layers, l_layers, guess, prior, gidx_maps=None):
        device = guess.t.device
        checkpoints = quality_checkpoints(params)
        pose = prev_pose = guess
        iteration = 0
        reason = _RUNNING
        finished = torch.zeros(len(self.solvers), dtype=torch.bool, device=device)
        # empty pairings with the full layout (max_iterations == 0)
        pairings = self._run_matchers(
            [False] * len(self.matchers), g_layers, l_layers, pose, 0
        )
        records = [] if params.record_iterations else None
        while reason == _RUNNING and iteration < params.max_iterations:
            with profile_scope("icp.iter"):
                m_active = [m.gate(iteration) > 0 for m in self.matchers]
                s_active = [s.gate(iteration) for s in self.solvers]
                pairings, pose_out, flags, finished = self._step(
                    params, prior, iteration, m_active, s_active, finished,
                    g_layers, l_layers, pose, prev_pose, gidx_maps,
                )
                if params.iteration_hook is not None:
                    flags = torch.cat([flags, torch.as_tensor(
                        params.iteration_hook(iteration, pose_out.R, pose_out.t, pairings.size()),
                        dtype=torch.bool, device=device).reshape(1)])
                with profile_scope("sync.icp_flags"):  # the iteration's one host sync
                    no_pairs, solver_ok, stalled, *stop = flags.tolist()
                prev_pose, pose = pose, pose_out
                iteration += 1
                if no_pairs:
                    reason = IterTermReason.NO_PAIRINGS
                elif not solver_ok:
                    reason = IterTermReason.SOLVER_ERROR
                elif stalled:
                    reason = IterTermReason.STALLED
                elif stop and stop[0]:
                    reason = IterTermReason.HOOK_REQUEST
                if reason == _RUNNING and iteration in checkpoints:
                    with profile_scope("icp.quality"):
                        q = self._quality_stack(pairings, g_layers, l_layers, pose, iteration)
                        with profile_scope("sync.icp_quality"):
                            q = float(q)
                    if q < checkpoints[iteration]:
                        reason = IterTermReason.QUALITY_CHECKPOINT_FAILED
                if params.debug_print_iteration_progress:
                    print(f"[ICP] iteration {iteration - 1}: {int(pairings.size())} pairings, "
                          f"t = {pose.t.tolist()}, {reason.name if reason else 'running'}")
                if records is not None:
                    records.append((pose, pairings.size(),
                                    pairings.decimated(params.record_pairings_capacity)
                                    if params.record_pairings else None))

        if reason == _RUNNING:
            reason = IterTermReason.MAX_ITERATIONS
        recorded = {}
        if records:
            # after termination the rows repeat the final state
            records += [records[-1]] * (params.max_iterations - len(records))
            recorded = stack_records(records)
        with profile_scope("icp.results"):
            return ICPResults(
                optimal_tf=pose,
                optimal_scale=self._optimal_scale(pairings, pose),
                n_iterations=iteration,
                termination_reason=reason,
                quality=self._quality_stack(pairings, g_layers, l_layers, pose, iteration),
                final_pairings=pairings,
                covariance=compute_covariance(pairings, pose),
                **recorded,
            )



def stack_records(records) -> dict:
    """The ICPResults fields of a list of per-iteration rows (pose, pair
    count, decimated pairings or None), stacked along a new leading axis."""
    def stack(trees):
        return pytree.tree_map(lambda *xs: torch.stack(xs), *trees)

    poses, counts, pairs = zip(*records)
    return {
        "iteration_poses": stack(poses),
        "iteration_pair_counts": torch.stack(counts).to(torch.int32),
        "iteration_pairings": None if pairs[0] is None else stack(pairs),
    }


def quality_checkpoints(params: ICPParameters) -> Dict[int, float]:
    """{iteration count: min quality}: the checkpoint after iteration `it`
    is tested once `it + 1` iterations have run (reference:
    ICP.cpp:259-283)."""
    checkpoints: Dict[int, float] = {}
    for it, min_q in params.quality_checkpoints:
        if 0 <= it < params.max_iterations:
            checkpoints[it + 1] = max(min_q, checkpoints.get(it + 1, min_q))
    return checkpoints
