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
device of the input tensors (``ICP._step``), and reads the three
termination flags back with one host sync. ``parallel.batch`` runs the same
step under ``torch.func.vmap`` for a batch of problems.

Not ported yet, and raising ``NotImplementedError`` when asked for:
``MetricMap`` input, ``record_iterations`` / ``record_pairings``,
``iteration_hook``, ``generate_debug_files``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pairings import BLOCK_TYPES, Pairings, concat_blocks
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.covariance import covariance as compute_covariance
from mp2p_icp_tpu_torch.matchers.base import (
    MatchContext,
    MatchState,
    point_layers,
    transformed_local,
)
from mp2p_icp_tpu_torch.quality.paired_ratio import QualityPairedRatio
from mp2p_icp_tpu_torch.solvers.gauss_newton import SE3Prior


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
    # not ported yet (each raises when set): per-iteration records, the
    # per-iteration hook and the debug log files
    record_iterations: bool = False
    record_pairings: bool = False
    iteration_hook: Optional[Callable] = None
    generate_debug_files: bool = False


class ICPResults(NamedTuple):
    """Reference: mp2p_icp/include/mp2p_icp/Results.h:29-58."""

    optimal_tf: Pose
    optimal_scale: torch.Tensor  # 1.0 (scale estimation is not ported)
    n_iterations: int
    termination_reason: IterTermReason
    quality: torch.Tensor
    final_pairings: Pairings
    covariance: torch.Tensor  # [6, 6]


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
        the Pairings layout is the same on every iteration. The paired
        masks are only kept when several matchers run together.
        ``gidx_maps``: the crop's index maps (see _crop_globals)."""
        device = pose.t.device
        state = MatchState.create(l_layers, g_layers) if sum(active) > 1 else None
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
        )

    # -------------------------------------------------------------- solvers
    def _run_solvers(self, pairings, pose, prev_pose, iteration, prior,
                     active, finished):
        """First enabled solver wins (reference: ICP::run_solvers,
        ICP.cpp:469-479). A solver with
        run_until_translation_correction_smaller_than > 0 runs until the
        last ICP step's translation norm |t_i - t_{i-1}| (unset on the first
        iteration) drops below it; a persistent per-solver latch
        (``finished``) then hands off to the next solver for good
        (Solver.cpp:44-60). Returns (new_pose, new_finished)."""
        act = [s for s, on in zip(self.solvers, active) if on]
        if not act:
            return pose, finished
        if not any(s.run_until_translation_correction_smaller_than > 0 for s in act):
            return act[0].solve(pairings, pose, prior, iteration=iteration), finished
        step_trans = float(torch.linalg.vector_norm(pose.t - prev_pose.t))
        has_step = iteration > 0
        finished = list(finished)
        taken = False
        result = pose
        for i, (s, on) in enumerate(zip(self.solvers, active)):
            if not on:
                continue
            thr = s.run_until_translation_correction_smaller_than
            if thr > 0:
                # latch only when this solver is consulted (no earlier win)
                finished[i] = finished[i] or (
                    not taken and has_step and step_trans < thr
                )
                run = not taken and not finished[i]
            else:
                run = not taken
            if run:
                result = s.solve(pairings, pose, prior, iteration=iteration)
            taken = taken or run
        return result, finished

    # ---------------------------------------------------------------- align
    def align(
        self,
        local_map: Dict[str, PointCloud],
        global_map: Dict[str, PointCloud],
        guess: Pose,
        params: Optional[ICPParameters] = None,
        prior: Optional[SE3Prior] = None,
    ) -> ICPResults:
        """Register local onto global starting from guess. Runs on the
        device of the input tensors."""
        params = params or ICPParameters()
        self._check_options(params)
        g_layers = point_layers(global_map)
        l_layers = point_layers(local_map)
        if not g_layers or not l_layers:
            raise ValueError("empty input maps")
        for name, layer in list(g_layers.items()) + list(l_layers.items()):
            if layer.device != guess.t.device:
                raise ValueError(
                    f"layer {name!r} is on {layer.device}, the guess on "
                    f"{guess.t.device}"
                )
        return self._align_full(params, g_layers, l_layers, guess, prior)

    def _check_options(self, params):
        if not self.matchers or not self.solvers:
            raise ValueError("ICP requires at least one matcher and one solver")
        for name in ("record_iterations", "record_pairings", "iteration_hook",
                     "generate_debug_files"):
            if getattr(params, name):
                raise NotImplementedError(
                    f"ICPParameters.{name} is not ported yet"
                )

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

        out = dict(g_layers)
        index_maps = {}
        for name in todo:
            g = g_layers[name]
            N = g.capacity
            inside = g.valid_mask() & torch.all((g.xyz >= lo) & (g.xyz <= hi), dim=1)
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

    def _step(self, params, prior, iteration, m_active, s_active, finished,
              g_layers, l_layers, pose, prev_pose, gidx_maps):
        """One ICP iteration on the device, without host syncs unless the
        run_until latch is active: matchers, solvers, and the termination
        flags. Returns (pairings, new_pose, no_pairs, solver_ok, stalled,
        finished)."""
        pairings = self._run_matchers(m_active, g_layers, l_layers, pose,
                                      iteration, gidx_maps)
        new_pose, finished = self._run_solvers(
            pairings, pose, prev_pose, iteration, prior, s_active, finished
        )
        no_pairs = pairings.size() == 0
        solver_ok = torch.isfinite(new_pose.t).all() & torch.isfinite(new_pose.R).all()
        # step-size + oscillation termination (ICP.cpp:191-229)
        eps_t, eps_r = params.min_abs_step_trans, params.min_abs_step_rot
        dt1, dr1 = se3.delta_norms(pose, new_pose)
        dt2, dr2 = se3.delta_norms(prev_pose, new_pose)
        stalled = ((dt1 < eps_t) & (dr1 < eps_r)) | ((dt2 < eps_t) & (dr2 < eps_r))
        return pairings, new_pose, no_pairs, solver_ok, stalled, finished

    def _align_core(self, params, g_layers, l_layers, guess, prior, gidx_maps=None):
        device = guess.t.device
        checkpoints = quality_checkpoints(params)
        pose = prev_pose = guess
        iteration = 0
        reason = _RUNNING
        finished = [False] * len(self.solvers)
        # empty pairings with the full layout (max_iterations == 0)
        pairings = self._run_matchers(
            [False] * len(self.matchers), g_layers, l_layers, pose, 0
        )
        while reason == _RUNNING and iteration < params.max_iterations:
            m_active = [m.gate(iteration) > 0 for m in self.matchers]
            s_active = [s.gate(iteration) for s in self.solvers]
            pairings, new_pose, no_pairs, solver_ok, stalled, finished = self._step(
                params, prior, iteration, m_active, s_active, finished,
                g_layers, l_layers, pose, prev_pose, gidx_maps,
            )
            # the iteration's one host sync
            no_pairs, solver_ok, stalled = torch.stack(
                [no_pairs, solver_ok, stalled]
            ).tolist()
            prev_pose = pose
            if solver_ok and not no_pairs:
                pose = new_pose
            iteration += 1
            if no_pairs:
                reason = IterTermReason.NO_PAIRINGS
            elif not solver_ok:
                reason = IterTermReason.SOLVER_ERROR
            elif stalled:
                reason = IterTermReason.STALLED
            if reason == _RUNNING and iteration in checkpoints:
                q = self._quality_stack(pairings, g_layers, l_layers, pose, iteration)
                if float(q) < checkpoints[iteration]:
                    reason = IterTermReason.QUALITY_CHECKPOINT_FAILED

        if reason == _RUNNING:
            reason = IterTermReason.MAX_ITERATIONS
        return ICPResults(
            optimal_tf=pose,
            optimal_scale=torch.ones((), device=device),
            n_iterations=iteration,
            termination_reason=reason,
            quality=self._quality_stack(pairings, g_layers, l_layers, pose, iteration),
            final_pairings=pairings,
            covariance=compute_covariance(pairings, pose),
        )


def quality_checkpoints(params: ICPParameters) -> Dict[int, float]:
    """{iteration count: min quality}: the checkpoint after iteration `it`
    is tested once `it + 1` iterations have run (reference:
    ICP.cpp:259-283)."""
    checkpoints: Dict[int, float] = {}
    for it, min_q in params.quality_checkpoints:
        if 0 <= it < params.max_iterations:
            checkpoints[it + 1] = max(min_q, checkpoints.get(it + 1, min_q))
    return checkpoints
