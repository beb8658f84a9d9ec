"""Exact brute-force k-nearest-neighbour search.

Port of ``mp2p_icp_tpu/ops/nn_bruteforce.py`` (``knn_bruteforce`` and its
batched use under ``jax.vmap``), with its contracts:

- invalid queries are moved to +1e8 and invalid points to -1e8 (sentinels
  of opposite sign, so two invalid entries never pair at distance ~0);
- ``dist_sq >= 0``; a pair is valid when its d² < 1e15, which covers query
  validity, point validity and padding with one test;
- an optional scalar or per-query ``max_radius_sq`` gate;
- invalid entries come back as idx -1 and dist_sq 3e37.

Three sweeps sit behind the front ends, one for each TPU kernel of the JAX
package. On CUDA tensors each launches its Hopper kernel; on CPU tensors it
runs its plain PyTorch version:

- ``knn_sweep``: ``csrc/knn_bruteforce.cu`` replaces ``_nnk_kernel_gridless``
  (K1); plain version ``knn_plain``;
- ``knn_sweep_streamed``: ``csrc/knn_streamed.cu`` replaces
  ``_nnk_kernel_streamed_dbuf`` (K3); plain version ``knn_plain_streamed``;
- ``knn_sweep_batched``: ``csrc/knn_batched.cu`` replaces
  ``_nnk_kernel_gridless_batched`` (K2); plain version ``knn_plain_batched``.

The three kernels share one device sweep (``csrc/knn_sweep.cuh``) and one
rule, ``sweep_split``, that lays a sweep on the card from (Q, C, B, k) and
the SM count: blocks of G warps, S slices of the point axis, the partial
lists merged in index order, so the result does not depend on the split.

K1 and K2 take optional counts, int32 tensors on the inputs' device: only
the first ``q_count`` queries are answered (later rows come back (+inf, -1))
and only the first ``p_count`` points are swept, the slices splitting that
prefix on the device. The front ends pass ``valid_count`` of each mask (the
last valid row + 1, two launches, no host read), so a padded cloud costs
the work of its valid rows and the call stays capturable in a CUDA graph.
Rows past the count are sentinels that pair at d² ≥ 1e15 with every valid
row whose coordinates lie within 8e7 of the origin on each axis, so the
front ends' ``NNResult`` is the uncounted sweep's.

``knn_bruteforce`` takes the streamed sweep for maps above ``stream_block``
points, as the JAX package does. It calls the sweep through a custom
operator whose vmap rule launches the batched sweep, so ``torch.func.vmap``
of anything that reaches ``knn_bruteforce`` (a matcher, a whole ICP
iteration) runs one batched launch for all problems: the counterpart of
the JAX ``custom_vmap`` rule. ``knn_bruteforce_batched`` is the batched
front end. ``knn_sharded`` (``knn_bruteforce(spatial_axis=...)``) is the
front end of a map split over ranks: each rank sweeps its shard with K1 or
K3 and the k-lists are merged after one all_gather; under vmap the sweep
is one K2 launch and the all_gather one for the whole batch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from mp2p_icp_tpu_torch.ops import cuda_build
from mp2p_icp_tpu_torch.utils import profiler
from mp2p_icp_tpu_torch.utils.profiler import profile_scope, spanned

_BIG = 3.0e37
_FAR = 1.0e8
MAX_K = 8
# maps above this many points take the streamed sweep (the JAX package's
# VMEM limit; on the card it only selects the entry point: every sweep
# splits the point axis as far as the card needs)
STREAM_BLOCK = 131072
_PLAIN_CHUNK = 1024  # queries per step of knn_plain: bounds its [chunk, C, 3] temporary
_WARP = 32
_GROUPS = (16, 8)  # warps per block the split rule may choose, in order of preference
_WARPS_PER_SM = (16, 32)  # what the split rule aims to keep in flight on every SM
_MIN_PART = 128  # fewest points a warp sweeps: one tile of its ring (knn_sweep.cuh kTile)
_TILES_KN = (4, 2, 1)  # register tiles of k > 1 (knn_sweep.cuh tile_allowed), largest first
_LONG_PART = 4096  # points per warp beyond which a longer part saves no list refills
_BALANCE_SLACK = 0.05  # forms this close to the best balance count as balanced
_MAX_GRID = 65535  # limit of the grid's slice and problem axes


class NNResult(NamedTuple):
    idx: torch.Tensor  # [..., Q, k] i32 (-1 invalid)
    dist_sq: torch.Tensor  # [..., Q, k] f32 (3e37 invalid)
    valid: torch.Tensor  # [..., Q, k] bool


class ShardedNNResult(NamedTuple):
    """``knn_sharded``'s result: NNResult's fields (idx global over the
    shards) and what no rank can gather from another's shard, merged with
    them: the neighbours' coordinates and ``point_payload`` rows."""

    idx: torch.Tensor  # [Q, k] i32 (-1 invalid)
    dist_sq: torch.Tensor  # [Q, k] f32 (3e37 invalid)
    valid: torch.Tensor  # [Q, k] bool
    xyz: torch.Tensor  # [Q, k, 3]
    payload: Optional[torch.Tensor] = None  # [Q, k, P]


# ------------------------------------------------------------ plain versions
def _leading(count, capacity: int) -> int:
    """A count argument as the number of leading rows it keeps (a host read
    where the count lies on the card: the plain versions are the yardstick,
    not the path)."""
    return capacity if count is None else min(max(int(count), 0), capacity)


def knn_plain(q: torch.Tensor, p: torch.Tensor, k: int, q_count=None, p_count=None):
    """Plain PyTorch kNN: explicit (q - p)² per pair, stable ascending sort,
    first k. The stable sort gives the lowest index on ties. Slots beyond
    the number of points stay (+inf, -1), as in the kernel. With counts,
    only the first ``q_count`` queries are answered (the other rows stay
    (+inf, -1)) against the first ``p_count`` points.
    Returns (d2 [Q, k] f32, idx [Q, k] i32)."""
    Q, C = q.shape[0], p.shape[0]
    out_d = torch.full((Q, k), float("inf"), dtype=torch.float32, device=q.device)
    out_i = torch.full((Q, k), -1, dtype=torch.int32, device=q.device)
    n_q, C = _leading(q_count, Q), _leading(p_count, C)
    q, p = q[:n_q], p[:C]
    kk = min(k, C)
    if kk == 0:
        return out_d, out_i
    for s in range(0, n_q, _PLAIN_CHUNK):
        e = min(s + _PLAIN_CHUNK, n_q)
        diff = q[s:e, None, :] - p[None, :, :]  # [chunk, C, 3]
        sq = diff * diff
        d = sq[..., 0] + sq[..., 1] + sq[..., 2]  # same rounding order as the kernel
        ds, order = torch.sort(d, dim=1, stable=True)
        out_d[s:e, :kk] = ds[:, :kk]
        out_i[s:e, :kk] = order[:, :kk].to(torch.int32)
    return out_d, out_i


def merge_sorted_k(d_acc, i_acc, new_d, new_i, k: int):
    """Merge two ascending [Q, k] lists into the k smallest, the first
    list's entries winning ties (``_merge_sorted_k`` of the JAX package)."""
    d = torch.cat([d_acc, new_d], dim=1)
    i = torch.cat([i_acc, new_i], dim=1)
    ds, order = torch.sort(d, dim=1, stable=True)
    return ds[:, :k], torch.gather(i, 1, order[:, :k])


def knn_plain_streamed(q: torch.Tensor, p: torch.Tensor, k: int,
                       stream_block: int = STREAM_BLOCK):
    """Plain version of the streamed sweep: ``knn_plain`` on each
    superblock of ``stream_block`` points, merged in order, so an earlier
    superblock wins a tie and the result equals ``knn_plain`` over the
    whole map bit for bit. Returns (d2 [Q, k], idx [Q, k])."""
    Q, C = q.shape[0], p.shape[0]
    d_acc = torch.full((Q, k), float("inf"), dtype=torch.float32, device=q.device)
    i_acc = torch.full((Q, k), -1, dtype=torch.int32, device=q.device)
    for s in range(0, C, stream_block):
        d, i = knn_plain(q, p[s:s + stream_block], k)
        d_acc, i_acc = merge_sorted_k(d_acc, i_acc, d, torch.where(i >= 0, i + s, -1), k)
    return d_acc, i_acc


def knn_plain_batched(q: torch.Tensor, p: torch.Tensor, k: int, q_count=None,
                      p_count=None):
    """Plain version of the batched sweep: ``knn_plain`` on each problem.
    q [B, Q, 3] or [Q, 3], p [B, C, 3] or [C, 3] (an unbatched side is
    shared by every problem). Counts: [B], or one for all problems.
    Returns (d2 [B, Q, k], idx [B, Q, k])."""
    B = q.shape[0] if q.ndim == 3 else p.shape[0]

    def nth(count, b):
        return None if count is None else count.reshape(-1)[b if count.numel() > 1 else 0]

    outs = [knn_plain(q[b] if q.ndim == 3 else q, p[b] if p.ndim == 3 else p, k,
                      nth(q_count, b), nth(p_count, b))
            for b in range(B)]
    return torch.stack([d for d, _ in outs]), torch.stack([i for _, i in outs])


# ------------------------------------------------------------------ kernels
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# r, groups, slice, S, nq, np, part_d, part_i, part_th, out_d, out_i: the
# tail of every sweep's entry point, before the stream
_SPLIT_ARGS = (_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P)
# the three sweeps' entry points: (q, Q, p, C, k) or, batched, (q, Q, q's
# batch stride, p, C, p's batch stride, B, k), then the split
K1 = cuda_build.Kernel("knn_bruteforce", "mp2p_knn_sweep_f32", (),
                       (_P, _I, _P, _I, _I) + _SPLIT_ARGS)
K3 = cuda_build.Kernel("knn_streamed", "mp2p_knn_sweep_streamed_f32", (),
                       (_P, _I, _P, _I, _I) + _SPLIT_ARGS)
K2 = cuda_build.Kernel("knn_batched", "mp2p_knn_sweep_batched_f32", (),
                       (_P, _I, _L, _P, _I, _L, _I, _I) + _SPLIT_ARGS)


def _check(k, **arrays):
    """Validate k and [..., N, 3] float32 arrays on one device; returns
    the device type ('cpu' or 'cuda')."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    devices = set()
    for name, (x, ndims) in arrays.items():
        if x.ndim not in ndims or x.shape[-1] != 3 or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of {ndims} dims ending in 3, "
                             f"got {tuple(x.shape)} {x.dtype}")
        if x.shape[-2] >= 2**31 // 3:
            raise ValueError("the kNN sweeps index with int32")
        devices.add(x.device)
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"the kNN sweeps have no kernel for {dev}")
    if dev.type == "cuda" and not all(x.is_contiguous() for x, _ in arrays.values()):
        raise ValueError("the kNN kernels need contiguous inputs")
    return dev.type


def _count_arg(name, count, entries, device):
    """A count argument as the kernel reads it: ``entries`` contiguous int32
    values on ``device`` (one count broadcast to several entries is
    copied), or None."""
    if count is None:
        return None
    if count.dtype != torch.int32 or count.device != device:
        raise ValueError(f"{name} must be int32 on {device}, got {count.dtype} on {count.device}")
    if count.numel() not in (1, entries):
        raise ValueError(f"{name} has {count.numel()} entries, want 1 or {entries}")
    return count.reshape(-1).expand(entries).contiguous()


def _count_rows(k, B, q, p, q_count, p_count, shared):
    """The trace's ``knn.rows`` counter of one sweep of B problems: k, B,
    the query and point rows each problem sweeps (its count tensor, left
    unread on the device, or the capacity where it takes none) and whether
    one map is shared by all problems. The front end's ``knn.query`` span
    around it is paired with it by order."""
    profiler.count("knn.rows", k, B, q.shape[-2] if q_count is None else q_count,
                   p.shape[-2] if p_count is None else p_count, shared)


_POSITIONS: dict = {}  # (C, device) -> int32 [1, ..., C], for valid_count


def valid_count(mask: torch.Tensor) -> torch.Tensor:
    """The rows a sweep must cover to meet every valid row of ``mask``
    [..., C]: the index of its last True + 1 (0 when none), int32 [...], on
    the mask's device. Two launches and no host read, so it may run inside a
    CUDA graph; exact for any mask (rows before the last valid one that are
    invalid are the front ends' sentinels)."""
    C = mask.shape[-1]
    if C == 0:
        return torch.zeros(mask.shape[:-1], dtype=torch.int32, device=mask.device)
    key = (C, mask.device)
    positions = _POSITIONS.get(key)
    if positions is None:
        positions = torch.arange(1, C + 1, dtype=torch.int32, device=mask.device)
        # a tensor made during a capture holds nothing until the graph runs
        if not (mask.device.type == "cuda" and torch.cuda.is_current_stream_capturing()):
            _POSITIONS[key] = positions
    return (positions * mask).amax(-1)  # int32: the positions of the valid rows


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def queries_per_thread(k: int) -> int:
    """The kernels' largest register tile for k: queries held by one
    thread, 8 for k = 1 and 4 for k > 1 (kQueriesK1 and kQueriesKn of
    knn_sweep.cuh, repeated here so that the split rule runs without the
    library; ``kernel_launch_dims`` reads the kernels' side). A k > 1
    launch may take a smaller tile: ``register_tile``."""
    return 8 if k == 1 else _TILES_KN[0]


def kernel_launch_dims(Q: int, B: int, r: int, groups: int, slices: int):
    """(grid x, grid y, grid z, threads per block) of the sweep kernel for
    these arguments (r: the register tile), answered by the built library
    from the functions its launch uses. Launches nothing."""
    fn = cuda_build.entry_point("knn_bruteforce", "mp2p_knn_sweep_launch_dims",
                                (_I, _I, _I, _I, _I, _P))
    out = (ctypes.c_int * 4)()
    fn(Q, B, r, groups, slices, out)
    return tuple(out)


class Split(NamedTuple):
    """How a sweep is laid on the card: blocks of ``groups`` warps, each
    block on one chunk of queries and one of ``slices`` slices of
    ``slice_len`` points, which its warps cut into ``groups`` contiguous
    parts."""
    groups: int
    slices: int
    slice_len: int


def split_form(chunks: int, C: int, n_sm: int, groups: int, warps_per_sm: int) -> Split:
    """The split with blocks of ``groups`` warps and the most slices that
    stay within ``warps_per_sm`` warps on every SM and leave every warp
    ``_MIN_PART`` points. A slice is whole 4-point groups for each warp, so
    every warp's part starts on a 16-byte border of an aligned map."""
    per_sm = max(1, warps_per_sm // groups)
    S = max(1, min(per_sm * n_sm // chunks, C // (groups * _MIN_PART), _MAX_GRID))
    align = 4 * groups
    slice_len = max(align, -(-(-(-C // S)) // align) * align)
    return Split(groups, max(1, -(-C // slice_len)), slice_len)


@functools.lru_cache(maxsize=1024)
def split_chunks(chunks: int, C: int, n_sm: int) -> Split:
    """The split for ``chunks`` query chunks (over all problems) of C
    points each on n_sm SMs. What decides a sweep's time, once some 16
    warps per SM hide the latencies, is how evenly the blocks fall on the
    SMs: equal blocks take ceil(blocks / n_sm) rounds, and the share of
    block slots that do work in those rounds is the balance. For each
    block size of ``_GROUPS`` and each target of ``_WARPS_PER_SM`` the
    candidate is ``split_form``; among the candidates within
    ``_BALANCE_SLACK`` of the best balance the one with the largest blocks
    and then the fewest slices wins, because every slice costs a list per
    query in scratch memory and a step of the merge."""
    cands = []
    for groups in _GROUPS:
        for warps in _WARPS_PER_SM:
            form = split_form(chunks, C, n_sm, groups, warps)
            blocks = chunks * form.slices
            cands.append((blocks / (-(-blocks // n_sm) * n_sm), form))
    best = max(balance for balance, _ in cands)
    return max((form for balance, form in cands if balance >= best - _BALANCE_SLACK),
               key=lambda form: (form.groups, -form.slices))


def _chunks(Q: int, r: int, B: int) -> int:
    """Query chunks (one per block and slice) of B problems of Q queries,
    r queries per thread."""
    return max(1, -(-Q // (_WARP * r))) * max(1, B)


@functools.lru_cache(maxsize=1024)
def register_tile(Q: int, C: int, n_sm: int, k: int = 1, B: int = 1) -> int:
    """Queries per thread of the launch: 8 for k = 1; for k > 1 the tile of
    ``_TILES_KN`` whose split gives each warp the longest part, counted up
    to ``_LONG_PART`` points, then the most warps in flight, counted up to
    15 per SM, then the largest tile. Each part fills and refines its own
    K-lists, about K (1 + ln(part / K)) insertions per query, so a small Q,
    which the split rule cuts into many short parts, takes a smaller tile
    (more query chunks, fewer parts each); a large one keeps the largest,
    which reads each point for the most queries."""
    if k == 1:
        return queries_per_thread(1)

    def score(r):
        chunks = _chunks(Q, r, B)
        split = split_chunks(chunks, C, n_sm)
        warps = chunks * split.slices * split.groups / n_sm
        return min(-(-split.slice_len // split.groups), _LONG_PART), min(warps, 15.0), r

    return max(_TILES_KN, key=score)


def sweep_split(Q: int, C: int, n_sm: int, k: int = 1, B: int = 1) -> Split:
    """The split of B problems of Q queries against C points each: one rule
    for the three kernels, a function of the sizes and the SM count only
    (with ``register_tile``'s queries per thread)."""
    return split_chunks(_chunks(Q, register_tile(Q, C, n_sm, k, B), B), C, n_sm)


def launch_shape(Q: int, C: int, n_sm: int, k: int = 1, B: int = 1) -> dict:
    """The launch configuration ``sweep_split`` leads to: queries per
    thread, blocks, warps, warps per SM and points per warp."""
    r = register_tile(Q, C, n_sm, k, B)
    split = sweep_split(Q, C, n_sm, k, B)
    blocks = _chunks(Q, r, B) * split.slices
    return {"queries_per_thread": r, "groups": split.groups, "slices": split.slices,
            "slice": split.slice_len, "blocks": blocks, "warps": blocks * split.groups,
            "warps_per_sm": blocks * split.groups / n_sm,
            "points_per_warp": -(-split.slice_len // split.groups)}


def _launch_split(kernel, q, p, k, B, head, counts=(None, None)):
    """Allocate the outputs (and the scratch when the points are split
    across blocks: the slices' lists and, for k > 1, the thresholds they
    pool, at +inf) and launch ``kernel`` on q's device. ``head``: the entry
    point's arguments before (r, groups, slice, S, ...); ``counts``: the
    (queries, points) count tensors of ``_count_arg``. Returns (d2 [B, Q,
    k], idx [B, Q, k]); launches nothing where Q or B is 0."""
    Q, C = q.shape[-2], p.shape[-2]
    dev = q.device
    out_d = torch.empty((B, Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, Q, k), dtype=torch.int32, device=dev)
    if Q == 0 or B == 0:
        return out_d, out_i
    n_sm = _sm_count(dev.index or 0)
    r = register_tile(Q, C, n_sm, k, B)
    groups, S, slice_len = sweep_split(Q, C, n_sm, k, B)
    part_d = part_i = part_th = None
    if S > 1:
        part_d = torch.empty((S, B * Q, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((S, B * Q, k), dtype=torch.int32, device=dev)
        if k > 1:
            part_th = torch.full((B * Q,), float("inf"), dtype=torch.float32, device=dev)
    cuda_build.launch(kernel, dev, B, (), *head, r, groups, slice_len, S, *counts, part_d,
                      part_i, part_th, out_d, out_i)
    return out_d, out_i


def knn_sweep(q: torch.Tensor, p: torch.Tensor, k: int, q_count=None, p_count=None):
    """k nearest points of p [C, 3] for each query of q [Q, 3] (f32,
    contiguous, one device). Returns (d2 [Q, k] f32 ascending, idx [Q, k]
    i32), lowest index first on ties, (+inf, -1) in unfilled slots.
    q_count / p_count: optional int32 counts (one value, on q's device):
    only the first q_count queries are answered against the first p_count
    points (``valid_count``).

    CPU tensors run ``knn_plain``; CUDA tensors launch the Hopper kernel
    (and raise if it cannot be built or launched — there is no fallback).
    ``cuda_build.launches["knn_bruteforce"]`` counts the launches (a sweep
    and the merge of its slices count as one)."""
    _count_rows(k, 1, q, p, q_count, p_count, False)
    if _check(k, q=(q, (2,)), p=(p, (2,))) == "cpu":
        return knn_plain(q, p, k, q_count, p_count)
    out_d, out_i = _launch_split(
        K1, q, p, k, 1, (q, q.shape[0], p, p.shape[0], k),
        (_count_arg("q_count", q_count, 1, q.device),
         _count_arg("p_count", p_count, 1, q.device)))
    return out_d[0], out_i[0]


def knn_sweep_streamed(q: torch.Tensor, p: torch.Tensor, k: int,
                       stream_block: int = STREAM_BLOCK):
    """``knn_sweep`` for large maps (``csrc/knn_streamed.cu``): on CUDA
    tensors the point axis is split across blocks and the partial lists are
    k-merged; CPU tensors run ``knn_plain_streamed`` with superblocks of
    ``stream_block`` points. Same result as ``knn_sweep``; it takes no
    counts yet and sweeps the whole map (the front end's ``_sweep_op``
    keeps the counts it was handed in the trace's ``knn.rows`` counter).
    ``cuda_build.launches["knn_streamed"]`` counts the launches (the slice
    sweep and its merge count as one)."""
    if _check(k, q=(q, (2,)), p=(p, (2,))) == "cpu":
        return knn_plain_streamed(q, p, k, stream_block)
    out_d, out_i = _launch_split(K3, q, p, k, 1, (q, q.shape[0], p, p.shape[0], k))
    return out_d[0], out_i[0]


def knn_sweep_batched(q: torch.Tensor, p: torch.Tensor, k: int, q_count=None,
                      p_count=None):
    """``knn_sweep`` for B independent problems in one launch: q [B, Q, 3]
    or [Q, 3], p [B, C, 3] or [C, 3]; an unbatched side is shared by every
    problem (read with batch stride 0, not copied). Returns (d2 [B, Q, k],
    idx [B, Q, k]). q_count / p_count: optional int32 counts as for
    ``knn_sweep``, [B] (one per problem) or one value for all.

    CPU tensors run ``knn_plain_batched``; CUDA tensors launch
    ``csrc/knn_batched.cu`` once for all problems.
    ``cuda_build.launches["knn_batched"]`` counts the launches."""
    if q.ndim != 3 and p.ndim != 3:
        raise ValueError("knn_sweep_batched needs a batched q or p; use knn_sweep")
    B = q.shape[0] if q.ndim == 3 else p.shape[0]
    if q.ndim == 3 and p.ndim == 3 and p.shape[0] != B:
        raise ValueError(f"batch sizes differ: q {q.shape[0]}, p {p.shape[0]}")
    _count_rows(k, B, q, p, q_count, p_count, q.ndim == 3 and p.ndim == 2)
    if _check(k, q=(q, (2, 3)), p=(p, (2, 3))) == "cpu":
        return knn_plain_batched(q, p, k, q_count, p_count)
    if B > _MAX_GRID:
        raise ValueError(f"knn_sweep_batched takes at most {_MAX_GRID} problems")
    Q, C = q.shape[-2], p.shape[-2]
    return _launch_split(
        K2, q, p, k, B,
        (q, Q, 3 * Q if q.ndim == 3 else 0, p, C, 3 * C if p.ndim == 3 else 0, B, k),
        (_count_arg("q_count", q_count, B if q.ndim == 3 else 1, q.device),
         _count_arg("p_count", p_count, B if p.ndim == 3 else 1, q.device)))


# ------------------------------------------- the sweep as a custom operator
@torch.library.custom_op("mp2p_icp_tpu_torch::knn_sweep", mutates_args=())
def _sweep_op(q: torch.Tensor, p: torch.Tensor, k: int, stream_block: int,
              q_count: Optional[torch.Tensor],
              p_count: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if p.shape[0] > stream_block:
        _count_rows(k, 1, q, p, q_count, p_count, False)  # K3 takes no counts yet
        return knn_sweep_streamed(q, p, k, stream_block)
    return knn_sweep(q, p, k, q_count, p_count)


@_sweep_op.register_vmap
def _sweep_op_vmap(info, in_dims, q, p, k, stream_block, q_count, p_count):
    """Under torch.func.vmap: one batched sweep for all problems (the JAX
    package's custom_vmap rule, nn_bruteforce.py:287-342). A count is [B]
    where it is batched, else one value for all problems."""
    def sides(x, d, count, cd):
        x, _ = cuda_build.launch_arg(x, d)
        if count is not None:
            count, _ = cuda_build.launch_arg(count, cd)
        # a side whose count differs by problem is given to each problem
        if d is None and cd is not None:
            x = x.expand(info.batch_size, *x.shape).contiguous()
        return x, count

    q, q_count = sides(q, in_dims[0], q_count, in_dims[4])
    p, p_count = sides(p, in_dims[1], p_count, in_dims[5])
    return knn_sweep_batched(q, p, k, q_count, p_count), (0, 0)


# --------------------------------------------------------------- front ends
def _result(d2, idx, C, radius) -> NNResult:
    """Validity from d² < 1e15 and the radius gate (radius broadcast
    against d2 [..., Q, k]), then -1 / 3e37 where invalid."""
    valid = (idx >= 0) & (idx < C) & (d2 < 1.0e15)
    if radius is not None:
        valid = valid & (d2 < radius)
    return NNResult(
        idx=torch.where(valid, idx, -1),
        dist_sq=torch.where(valid, d2, _BIG),
        valid=valid,
    )


def knn_bruteforce(
    queries: torch.Tensor,
    query_valid: torch.Tensor,
    points: torch.Tensor,
    point_valid: torch.Tensor,
    k: int = 1,
    max_radius_sq=None,
    stream_block: int = STREAM_BLOCK,
    spatial_axis=None,
    point_payload: Optional[torch.Tensor] = None,
):
    """Exact kNN of queries [Q, 3] among points [C, 3]: an NNResult (a
    ShardedNNResult with ``spatial_axis``).

    max_radius_sq: scalar or [Q] — pairs at or beyond it are invalidated.
    stream_block: maps of more than this many points take the streamed
    sweep (same result; on the CPU also its superblock size).
    spatial_axis: a ``parallel.mesh.MeshAxis`` when ``points`` is this
    rank's shard of a map split over the axis (shard s holds rows [s·C,
    (s+1)·C) of the whole map): see ``knn_sharded``.
    point_payload: [C, P] rows that travel with the neighbours (the sharded
    path only; ignored otherwise: a local caller gathers them by idx).
    """
    if spatial_axis is not None:
        return knn_sharded(queries, query_valid, points, point_valid, spatial_axis, k,
                           max_radius_sq, stream_block, point_payload)
    with profile_scope("knn.query"):
        q = torch.where(query_valid[:, None], queries, _FAR).contiguous()
        p = torch.where(point_valid[:, None], points, -_FAR).contiguous()
        d2, idx = _sweep_op(q, p, k, stream_block, valid_count(query_valid),
                            valid_count(point_valid))
        r = max_radius_sq  # a number, or a tensor on d2's device
        if isinstance(r, torch.Tensor) and r.ndim == 1:
            r = r[:, None]
        return _result(d2, idx, points.shape[0], r)


def knn_sharded(queries, query_valid, points, point_valid, axis, k: int = 1,
                max_radius_sq=None, stream_block: int = STREAM_BLOCK,
                point_payload: Optional[torch.Tensor] = None) -> ShardedNNResult:
    """The kNN over a map split across the ranks of ``axis`` (the JAX
    package's spatial_axis path, nn_bruteforce.py:734-765): each rank
    sweeps its own shard (K1, or K3 above ``stream_block`` rows), takes
    its neighbours' coordinates and payload rows from it, and one
    all_gather brings every rank's k-list (d², global idx = shard·C +
    local, xyz, payload, packed in one float32 tensor) to every rank,
    where a stable sort on d² keeps the k nearest. Equal d² keep the lower
    shard, and each shard's sweep the lower index, so the result equals
    one sweep of the whole map, d² and idx to the bit; every rank gets the
    same result. Under ``torch.func.vmap`` every problem's shard is swept
    in one K2 launch and the whole batch's k-lists in one all_gather."""
    from mp2p_icp_tpu_torch.parallel.mesh import MeshAxis

    if not isinstance(axis, MeshAxis):
        raise TypeError(f"spatial_axis is this rank's parallel.mesh.MeshAxis, not {axis!r}")
    res = knn_bruteforce(queries, query_valid, points, point_valid, k=k,
                         max_radius_sq=max_radius_sq, stream_block=stream_block)
    C = points.shape[0]
    Q = queries.shape[0]
    gidx = torch.where(res.valid, res.idx + axis.rank * C, -1)
    safe = torch.clamp(res.idx, 0, C - 1).long()
    cols = [res.dist_sq[..., None], points[safe]]
    if point_payload is not None:
        cols.append(point_payload[safe])
    vals, ids = _SpaceGather.apply(torch.cat(cols, dim=-1), gidx, axis)  # [n, Q, k, 4 (+P)], [n, Q, k]
    vals = vals.movedim(0, 1).reshape(Q, axis.size * k, -1)
    ids = ids.movedim(0, 1).reshape(Q, axis.size * k)
    _, sel = torch.sort(vals[..., 0], dim=1, stable=True)
    sel = sel[:, :k]
    best = torch.gather(vals, 1, sel[..., None].expand(-1, -1, vals.shape[-1]))
    idx = torch.gather(ids, 1, sel)
    valid = idx >= 0
    return ShardedNNResult(
        idx=idx,
        dist_sq=torch.where(valid, best[..., 0], _BIG),
        valid=valid,
        xyz=best[..., 1:4],
        payload=best[..., 4:] if point_payload is not None else None,
    )


knn_sharded.gathers = 0


class _SpaceGather(torch.autograd.Function):
    """``knn_sharded``'s one all_gather over the ranks of ``axis``: the
    float32 columns [..., F] and the int32 global ids [...] of every rank's
    k-lists, packed bit for bit into one float32 block and unpacked after,
    so each comes back with a leading [n]. Its vmap rule makes the batched
    align over a data x space mesh gather the whole batch [B, ...] in one
    collective, not one per problem, the batch on axis 1 of the results.
    The packing happens here, on plain tensors: a dtype view has no
    batching rule. ``knn_sharded.gathers`` counts the collectives."""

    @staticmethod
    def forward(vals, ids, axis):
        from mp2p_icp_tpu_torch.parallel.mesh import all_gather

        knn_sharded.gathers += 1
        packed = all_gather(torch.cat([vals, ids.view(torch.float32)[..., None]], dim=-1), axis)
        return packed[..., :-1], packed[..., -1].contiguous().view(torch.int32)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, vals, ids, axis):
        def batched(x, d):
            return x.movedim(d, 0) if d is not None else x.expand(info.batch_size, *x.shape)

        vals, ids = batched(vals, in_dims[0]), batched(ids, in_dims[1])
        return _SpaceGather.apply(vals, ids, axis), (1, 1)


@spanned("knn.query")
def knn_bruteforce_batched(
    queries: torch.Tensor,
    query_valid: torch.Tensor,
    points: torch.Tensor,
    point_valid: torch.Tensor,
    k: int = 1,
    max_radius_sq=None,
) -> NNResult:
    """``knn_bruteforce`` for B problems at once: queries [B, Q, 3] with
    query_valid [B, Q]; points [B, C, 3] with point_valid [B, C], or one
    shared [C, 3] map with [C]. max_radius_sq: scalar, [B] (per problem) or
    [B, Q]. Returns an NNResult of [B, Q, k], from one batched sweep."""
    q = torch.where(query_valid[..., None], queries, _FAR).contiguous()
    p = torch.where(point_valid[..., None], points, -_FAR).contiguous()
    d2, idx = knn_sweep_batched(q, p, k, valid_count(query_valid), valid_count(point_valid))
    r = max_radius_sq
    if isinstance(r, torch.Tensor) and r.ndim >= 1:
        r = r[:, None, None] if r.ndim == 1 else r[..., None]
    return _result(d2, idx, points.shape[-2], r)
