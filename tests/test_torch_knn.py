"""Parity of the port's kNN front end and one-to-one resolver with the JAX
package, on the CPU (where the port's sweep is ``knn_plain``).

The JAX kNN runs both ways its own tests run it on the CPU: the Pallas
kernel in interpret mode and the XLA path. Comparison is tie-tolerant
(``mp2p_icp_tpu_torch.parity``): the true d² of the port's neighbour must
lie within 2e-3 m² of the true d² of the reference's neighbour at the same
rank, and validity may differ only within that band of the radius. The
band is the reference's own: its |p|² - 2q·p + |q|² distances are off by up
to ~2.4e-3 m² at these coordinates (measured on these cases), so a
neighbour closer than that to the runner-up may come back either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu.ops import nn as jnn
from mp2p_icp_tpu.ops import nn_bruteforce as jnb
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch.eval.gn_problem import gn_problem
from mp2p_icp_tpu_torch.ops import cuda_build
from mp2p_icp_tpu_torch.ops import icp_terminate as term
from mp2p_icp_tpu_torch.ops import nn as tnn
from mp2p_icp_tpu_torch.ops import nn_bruteforce as tnb
from mp2p_icp_tpu_torch.solvers import gauss_newton as gn
from mp2p_icp_tpu_torch.parity import TIE_TOL, knn_mismatch, true_dist_sq


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _problem(Q, C, seed, extent=60.0):
    rng = np.random.RandomState(seed)
    q = rng.uniform(-extent, extent, (Q, 3)).astype(np.float32)
    p = rng.uniform(-extent, extent, (C, 3)).astype(np.float32)
    # half of the queries sit near a point, as in a registration
    near = rng.rand(Q) < 0.5
    q[near] = p[rng.randint(0, C, near.sum())] + 0.3 * rng.randn(near.sum(), 3)
    qv = rng.rand(Q) > 0.1
    pv = rng.rand(C) > 0.1
    return q, qv, p, pv, rng


def _port(q, qv, p, pv, k, radius):
    r = None if radius is None else torch.as_tensor(radius)
    return tnb.knn_bruteforce(
        torch.from_numpy(q), torch.from_numpy(qv), torch.from_numpy(p),
        torch.from_numpy(pv), k=k, max_radius_sq=r,
    )


# (Q, C, k, radius kind): ragged sizes, every k class, both radius forms
CASES = [
    (300, 1000, 1, "scalar"),
    (777, 3001, 4, "per_query"),
    (777, 3001, 8, None),
    (777, 3001, 1, "per_query"),
]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("Q,C,k,radius", CASES)
def test_knn_matches_jax(backend, Q, C, k, radius):
    q, qv, p, pv, rng = _problem(Q, C, seed=Q + C + k)
    if radius == "scalar":
        r = np.float32(4.0)
    elif radius == "per_query":
        r = rng.uniform(0.5, 50.0, Q).astype(np.float32)
    else:
        r = None
    ref = jnb.knn_bruteforce(
        jnp.asarray(q), jnp.asarray(qv), jnp.asarray(p), jnp.asarray(pv), k=k,
        max_radius_sq=None if r is None else jnp.asarray(r),
        backend=backend, interpret=backend == "pallas",
    )
    res = _port(q, qv, p, pv, k, r)
    idx, valid = res.idx.numpy(), res.valid.numpy()
    bad = knn_mismatch(q, p, idx, valid, np.asarray(ref.idx),
                       np.asarray(ref.dist_sq), np.asarray(ref.valid), radius_sq=r)
    assert not bad.any(), f"{bad.sum()} entries disagree beyond ties"
    # contracts: int32 indices, -1 / 3e37 where invalid, no invalid query
    # or point ever paired, d2 exact in f32 (1e-4 relative to the f64 value)
    assert res.idx.dtype == torch.int32 and res.dist_sq.dtype == torch.float32
    assert (idx[~valid] == -1).all() and (res.dist_sq.numpy()[~valid] == 3.0e37).all()
    assert not valid[~qv].any()
    assert pv[idx[valid]].all()
    d_true = true_dist_sq(q, p, idx)[valid]
    np.testing.assert_allclose(res.dist_sq.numpy()[valid], d_true, rtol=1e-4, atol=1e-5)
    # ascending per row
    d = res.dist_sq.numpy()
    assert (np.diff(d, axis=1) >= 0).all()


def test_knn_plain_tie_break_lowest_index():
    # exact duplicates of one point: the lowest index must come first
    p = np.zeros((10, 3), np.float32)
    p[3:7] = 1.0
    q = np.ones((2, 3), np.float32)
    d, idx = tnb.knn_plain(torch.from_numpy(q), torch.from_numpy(p), 3)
    assert idx.tolist() == [[3, 4, 5], [3, 4, 5]]
    assert (d == 0).all()


def test_knn_plain_fewer_points_than_k():
    q = torch.zeros(4, 3)
    p = torch.ones(2, 3)
    d, idx = tnb.knn_plain(q, p, 5)
    assert idx[:, 2:].eq(-1).all() and torch.isinf(d[:, 2:]).all()
    res = tnb.knn_bruteforce(q, torch.ones(4, dtype=torch.bool), p,
                             torch.ones(2, dtype=torch.bool), k=5)
    assert res.valid.sum().item() == 8
    assert (res.idx[:, 2:] == -1).all()


def test_knn_sweep_checks_arguments():
    q = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tnb.knn_sweep(q, q, 9)
    with pytest.raises(ValueError):
        tnb.knn_sweep(q.double(), q.double(), 1)
    with pytest.raises(TypeError, match="MeshAxis"):  # an axis name, not the rank's axis
        tnb.knn_bruteforce(q, torch.ones(4, dtype=torch.bool), q,
                           torch.ones(4, dtype=torch.bool), spatial_axis="space")


def test_knn_cpu_path_does_not_count_launches():
    before = cuda_build.launches["knn_bruteforce"]
    tnb.knn_sweep(torch.zeros(4, 3), torch.ones(5, 3), 2)
    assert cuda_build.launches["knn_bruteforce"] == before


@pytest.mark.parametrize("library", list(cuda_build.LIBRARIES))
def test_every_kernel_counts_from_its_reset_and_nothing_on_the_cpu(library):
    """The one launch count: every library's reads what it was reset to,
    and its wrapper on CPU tensors counts nothing, whether it runs the
    plain version (the sweeps) or is refused (the port's own kernels)."""
    pairings, guess = gn_problem(0, n_pt=8, n_pl=8)
    q, p = torch.zeros(4, 3), torch.ones(5, 3)
    calls = {
        "knn_bruteforce": lambda: tnb.knn_sweep(q, p, 2),
        "knn_streamed": lambda: tnb.knn_sweep_streamed(q, p, 2, stream_block=2),
        "knn_batched": lambda: tnb.knn_sweep_batched(q[None], p, 2),
        "gn_solve": lambda: gn.gn_solve_fused(pairings, guess, gn.GNParams()),
        "icp_terminate": lambda: term.terminate_fused(pairings, guess, guess, guess, 1e-4,
                                                      1e-4),
    }
    assert calls.keys() == cuda_build.LIBRARIES.keys()
    cuda_build.launches[library] = 7
    cuda_build.reset_launches()
    assert cuda_build.launches == dict.fromkeys(cuda_build.LIBRARIES, 0)
    if library.startswith("knn_"):
        calls[library]()
    else:
        with pytest.raises(ValueError, match="runs on the card"):
            calls[library]()
    assert cuda_build.launches[library] == 0


def _grid_problem(Q, C, seed):
    """Queries and points on a coarse integer grid: many exact duplicates
    and equal distances, so only the order of the merge decides which
    index comes back."""
    rng = np.random.RandomState(seed)
    q = rng.randint(0, 5, (Q, 3)).astype(np.float32)
    p = rng.randint(0, 5, (C, 3)).astype(np.float32)
    return torch.from_numpy(q), torch.from_numpy(p)


def _split_and_merge(q, p, k, starts):
    """knn_plain on each contiguous part [starts[i], starts[i+1]) merged in
    order with merge_sorted_k: what the kernels' groups and slices do."""
    Q = q.shape[0]
    d_acc = torch.full((Q, k), float("inf"))
    i_acc = torch.full((Q, k), -1, dtype=torch.int32)
    for a, b in zip(starts[:-1], starts[1:]):
        d, i = tnb.knn_plain(q, p[a:b], k)
        d_acc, i_acc = tnb.merge_sorted_k(d_acc, i_acc, d, torch.where(i >= 0, i + a, -1), k)
    return d_acc, i_acc


def _part_starts(C, S, slice_len, groups):
    """The borders of the contiguous parts that S slices of slice_len
    points, each split among `groups` warps, cut C points into (the
    arithmetic of sweep_block in csrc/knn_sweep.cuh)."""
    starts = []
    for s in range(S):
        begin = min(C, s * slice_len)
        end = min(C, begin + slice_len)
        part = ((-(-max(end - begin, 0) // groups)) + 3) & ~3
        starts += [min(end, begin + g * part) for g in range(groups)]
    return starts + [C]


# (Q, C, SM count, B): the shapes of the ported paths and of the odometry
# step on a 132-SM card, a small card, and sizes below one tile and one group
SPLIT_SHAPES = [(8192, 8192, 132, 1), (6144, 16384, 132, 1), (2048, 16384, 132, 1),
                (8192, 65536, 132, 1), (8192, 65536, 132, 8), (8192, 65536, 132, 2),
                (777, 3001, 132, 8), (5000, 200_003, 132, 1), (8192, 1 << 18, 132, 1),
                (1, 300_000, 132, 1), (8192, 1, 132, 1), (64, 5000, 8, 1), (33, 5, 132, 1),
                (100, 0, 132, 1), (1, 1 << 24, 132, 1), (70_000, 3001, 132, 1)]


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("Q,C,n_sm,B", SPLIT_SHAPES)
def test_split_rule_covers_points_and_respects_limits(Q, C, n_sm, B, k):
    groups, S, slice_len = tnb.sweep_split(Q, C, n_sm, k, B)
    assert groups in tnb._GROUPS and groups <= 16  # kMaxGroups of knn_sweep.cuh
    # the slices cover C exactly once, none empty but the only one of C = 0
    assert 1 <= S <= 65535 and B <= 65535
    assert S * slice_len >= C and (S - 1) * slice_len < max(C, 1)
    # alignment: every warp's part starts on a multiple of 4 points
    assert slice_len % (4 * groups) == 0
    starts = _part_starts(C, S, slice_len, groups)
    assert starts[0] == 0 and starts[-1] == C
    assert all(a <= b for a, b in zip(starts[:-1], starts[1:]))
    assert all(a % 4 == 0 for a in starts[:-1] if a < C)
    # the split is only as deep as the card needs and the points allow
    shape = tnb.launch_shape(Q, C, n_sm, k, B)
    assert shape["slices"] == S and shape["groups"] == groups
    assert shape["blocks"] <= 2**31 - 1
    r = tnb.register_tile(Q, C, n_sm, k, B)
    assert r == shape["queries_per_thread"] and r in ((8,) if k == 1 else tnb._TILES_KN)
    chunks = -(-Q // (32 * r)) * B
    if S > 1:
        assert chunks * S <= max(1, max(tnb._WARPS_PER_SM) // groups) * n_sm
        assert C // S >= groups * tnb._MIN_PART


@pytest.mark.parametrize("Q,C,k,B,r", [(8192, 8192, 8, 1, 2), (2048, 22528, 8, 1, 1),
                                       (6144, 6144, 8, 1, 1), (2048, 22528, 8, 8, 4),
                                       (8192, 262144, 8, 1, 4), (1081, 1081, 5, 1, 1),
                                       (8192, 8192, 1, 1, 8)])
def test_register_tile_takes_the_longest_parts(Q, C, k, B, r):
    """The tile of each path's shape on a 132-SM card: the longest parts
    (up to _LONG_PART points), then the most warps, then the largest tile;
    k = 1 always holds 8 queries a thread."""
    assert tnb.register_tile(Q, C, 132, k, B) == r
    if k > 1:
        def part(t):
            split = tnb.split_chunks(-(-Q // (32 * t)) * B, C, 132)
            return min(-(-split.slice_len // split.groups), tnb._LONG_PART)
        assert part(r) == max(part(t) for t in tnb._TILES_KN)


@pytest.mark.parametrize("chunks", [1, 7, 13, 48, 64, 79, 128, 131, 132, 133, 512, 5000])
@pytest.mark.parametrize("C", [100, 3001, 16384, 1 << 18])
def test_split_rule_balances_the_blocks(chunks, C):
    """Among the forms it may choose (each block size, 16 or 32 warps per
    SM), the rule's is within the slack of the best balance, and no form
    that balanced has larger blocks, or as large blocks and fewer slices."""
    n_sm = 132
    groups, S, _ = tnb.split_chunks(chunks, C, n_sm)

    def balance(blocks):
        return blocks / (-(-blocks // n_sm) * n_sm)

    forms = []
    for g in tnb._GROUPS:
        for warps in tnb._WARPS_PER_SM:
            s = max(1, min(max(1, warps // g) * n_sm // chunks, C // (g * tnb._MIN_PART)))
            forms.append((balance(chunks * s), g, s))
    floor = max(b for b, _, _ in forms) - tnb._BALANCE_SLACK
    assert balance(chunks * S) >= floor
    for b, g, s in forms:
        if b >= floor:
            assert (g, -s) <= (groups, -S)


def test_split_rule_fills_the_card_at_the_main_shapes():
    """At least ~16 warps per SM of a 132-SM card at the scan-to-scan and
    odometry shapes, for one problem and for a batch of two."""
    for Q, C, k, B in [(8192, 8192, 1, 1), (6144, 16384, 1, 1), (2048, 16384, 8, 1),
                       (8192, 65536, 1, 1), (8192, 65536, 1, 2), (8192, 65536, 1, 8)]:
        assert tnb.launch_shape(Q, C, 132, k, B)["warps_per_sm"] >= 15.5, (Q, C, k, B)


def test_split_rule_and_kernel_header_agree_on_their_constants():
    """The wrapper sizes the grid with the register tile, the ring's tile
    and the block limit that the kernels are built with."""
    import pathlib
    import re

    header = (pathlib.Path(tnb.__file__).parents[1] / "csrc" / "knn_sweep.cuh").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", header).group(1))

    assert tnb.queries_per_thread(1) == constant("kQueriesK1")
    assert all(tnb.queries_per_thread(k) == constant("kQueriesKn") for k in range(2, 9))
    # the k > 1 tiles the rule may choose are the ones the kernel dispatches
    assert re.search(r"return k == 1 \? r == kQueriesK1 : \(r == 1 \|\| r == 2 \|\| "
                     r"r == kQueriesKn\);", header)
    assert tnb._TILES_KN == (constant("kQueriesKn"), 2, 1)
    assert tnb._MIN_PART == constant("kTile")
    assert max(tnb._GROUPS) <= constant("kMaxGroups")
    # a k > 1 window's hits are one bit per group in a 32-bit mask
    assert 1 <= constant("kShareGroups") <= 32
    # a block fits the card's 227 KB of shared memory: each warp's ring,
    # reused for its R lists of K (distance, index) entries, and for k > 1
    # the block's pooled bound and each warp's half-list distance of each of
    # its 32 R queries
    ring = constant("kStages") * 3 * constant("kTile") * 4
    G = max(tnb._GROUPS)
    assert G * max(ring, constant("kQueriesK1") * 32 * 8) <= 227 * 1024
    R = constant("kQueriesKn")
    assert G * max(ring, R * tnb.MAX_K * 32 * 8) + (1 + G) * R * 32 * 4 <= 227 * 1024


def _device_slices(n_p, S):
    """The slices of the points [0, n_p) that block row s of a counted
    sweep covers (the arithmetic of knn_sweep_kernel in csrc/knn_sweep.cuh):
    [s·L, min((s+1)·L, n_p)) with L = ceil(n_p / S) rounded up to whole
    4-point groups."""
    L = ((-(-n_p // S)) + 3) & ~3
    slices = []
    for s in range(S):
        begin = min(n_p, s * L)
        slices.append((begin, min(n_p, begin + L)))
    return slices


def _device_part_starts(n_p, S, groups):
    """``_part_starts`` for a counted sweep: each device slice of
    ``_device_slices`` cut into ``groups`` parts as sweep_block cuts it."""
    starts = []
    for begin, end in _device_slices(n_p, S):
        part = ((-(-(end - begin) // groups)) + 3) & ~3
        starts += [min(end, begin + g * part) for g in range(groups)]
    return starts + [n_p]


@pytest.mark.parametrize("counted", [False, True])
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("Q,C,n_sm", [(300, 3001, 132), (64, 5000, 8), (33, 5, 132),
                                      (8192, 2048, 132), (1, 20_000, 132)])
def test_split_and_merge_in_order_equals_knn_plain(Q, C, n_sm, k, counted):
    """Bit for bit on tie-heavy inputs, for the parts the rule chooses at
    this shape and for a deeper and an uneven split; counted: the first
    n_q queries against the first n_p points, the slices split on the
    device from n_p, the rows past n_q (+inf, -1)."""
    q, p = _grid_problem(min(Q, 300), C, seed=Q + C + k)
    n_q, n_p = (q.shape[0] * 2 // 3 + 1, (C * 3 // 5) | 1 if C > 1 else C) if counted else (
        q.shape[0], C)
    count = (torch.tensor(n_q, dtype=torch.int32), torch.tensor(n_p, dtype=torch.int32))
    d_ref, i_ref = tnb.knn_plain(q, p, k, *count) if counted else tnb.knn_plain(q, p, k)
    groups, S, slice_len = tnb.sweep_split(Q, C, n_sm, k)
    forms = ((S, slice_len, groups), (-(-C // 48) if C else 1, 48, 3), (1, C + 16, 16))
    for S_, slice_, groups_ in forms:
        starts = (_device_part_starts(n_p, S_, groups_) if counted
                  else _part_starts(C, S_, slice_, groups_))
        d, i = _split_and_merge(q, p[:n_p], k, starts)
        d[n_q:], i[n_q:] = float("inf"), -1
        assert torch.equal(d, d_ref) and torch.equal(i, i_ref), starts[:8]


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("Q,C,n_sm,B", SPLIT_SHAPES)
def test_device_slices_cover_the_counted_points_once_in_order(Q, C, n_sm, B, k):
    """For every form of the split rule and counts from 0 to C, the slices
    and parts a counted sweep computes on the device cover [0, n_p) exactly
    once, in order, each part starting on a whole 4-point group, and no
    slice holds more than its share (L = ceil(n_p / S) rounded up to 4)."""
    groups, S, _ = tnb.sweep_split(Q, C, n_sm, k, B)
    for n_p in sorted({0, 1, 3, 4, 5, C // 3, C // 2 + 1, max(C - 1, 0), C}):
        if n_p > C:
            continue
        slices = _device_slices(n_p, S)
        assert slices[0][0] == 0 and slices[-1][1] == n_p
        assert all(a[1] == b[0] for a, b in zip(slices[:-1], slices[1:]))
        assert all(b - a <= (-(-n_p // S)) + 3 for a, b in slices)
        starts = _device_part_starts(n_p, S, groups)
        assert starts[0] == 0 and starts[-1] == n_p
        assert all(a <= b for a, b in zip(starts[:-1], starts[1:]))
        assert all(a % 4 == 0 for a in starts[:-1] if a < n_p)


def _masks(kind, Q, C, rng):
    """(query mask, point mask) of one kind of padded cloud."""
    qv, pv = np.zeros(Q, bool), np.zeros(C, bool)
    if kind == "prefix":  # a compacted layer: valid rows first
        qv[:Q * 3 // 4], pv[:C // 2 + 3] = True, True
    elif kind == "scattered":  # interior invalid rows, a padded tail
        qv[:Q - 17], pv[:C - 29] = rng.rand(Q - 17) > 0.3, rng.rand(C - 29) > 0.3
    elif kind == "count 0":
        qv[:] = True
    elif kind == "count 1":
        qv[:Q // 2], pv[0] = True, True
    elif kind == "fewer points than k":
        qv[:], pv[[2, 5, 6]] = True, True
    elif kind == "one valid query":
        qv[Q // 3], pv[:C - 1] = True, True
    else:  # counts not a multiple of 4: 4n + 1, 4n + 2, 4n + 3
        n = int(kind.split("+")[1])
        qv[:4 * 9 + n], pv[:4 * 37 + n] = True, True
    return qv, pv


MASK_KINDS = ["prefix", "scattered", "count 0", "count 1", "fewer points than k",
              "one valid query", "4n+1", "4n+2", "4n+3"]


def _uncounted(q, qv, p, pv, k, radius=None):
    """The front end as it was without counts: sentinels, the whole sweep."""
    qs = torch.where(qv[..., None], q, 1.0e8).contiguous()
    ps = torch.where(pv[..., None], p, -1.0e8).contiguous()
    if q.ndim == 3:
        d, i = tnb.knn_plain_batched(qs, ps, k)
    else:
        d, i = tnb.knn_plain(qs, ps, k)
    return tnb._result(d, i, p.shape[-2], radius)


@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("kind", MASK_KINDS)
def test_valid_count_and_counted_front_end(kind, k):
    """valid_count is the last valid row + 1; knn_bruteforce, which sweeps
    only those rows, gives the uncounted sweep's NNResult exactly, and the
    counted plain version answers the rows below the query count as the
    uncounted one does."""
    Q, C = 203, 517
    q, _, p, _, rng = _problem(Q, C, seed=k)
    qv, pv = _masks(kind, Q, C, rng)
    qt, pt, qvt, pvt = (torch.from_numpy(x) for x in (q, p, qv, pv))
    n_q, n_p = tnb.valid_count(qvt), tnb.valid_count(pvt)
    assert n_q.dtype == torch.int32 and n_q.shape == ()
    assert int(n_q) == (np.flatnonzero(qv)[-1] + 1 if qv.any() else 0)
    assert int(n_p) == (np.flatnonzero(pv)[-1] + 1 if pv.any() else 0)
    res = tnb.knn_bruteforce(qt, qvt, pt, pvt, k=k)
    ref = _uncounted(qt, qvt, pt, pvt, k)
    for a, e in zip(res, ref):
        assert torch.equal(a, e)
    qs = torch.where(qvt[:, None], qt, 1.0e8)
    ps = torch.where(pvt[:, None], pt, -1.0e8)
    d, i = tnb.knn_plain(qs, ps, k, n_q, n_p)
    d_all, i_all = tnb.knn_plain(qs[:int(n_q)], ps[:int(n_p)], k)
    assert torch.equal(d[:int(n_q)], d_all) and torch.equal(i[:int(n_q)], i_all)
    assert torch.isinf(d[int(n_q):]).all() and (i[int(n_q):] == -1).all()


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("k,kind", [(1, "prefix"), (8, "scattered"), (5, "fewer points than k"),
                                    (4, "4n+3"), (8, "count 1")])
def test_counted_front_end_matches_jax(backend, k, kind):
    """The counted front end against JAX's knn_bruteforce, run both ways its
    own tests run it, within the kNN band (parity.py), with a radius."""
    Q, C = 203, 517
    q, _, p, _, rng = _problem(Q, C, seed=11 + k)
    qv, pv = _masks(kind, Q, C, rng)
    r = rng.uniform(0.5, 50.0, Q).astype(np.float32)
    ref = jnb.knn_bruteforce(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(p), jnp.asarray(pv),
                             k=k, max_radius_sq=jnp.asarray(r), backend=backend,
                             interpret=backend == "pallas")
    res = _port(q, qv, p, pv, k, r)
    bad = knn_mismatch(q, p, res.idx.numpy(), res.valid.numpy(), np.asarray(ref.idx),
                       np.asarray(ref.dist_sq), np.asarray(ref.valid), radius_sq=r)
    assert not bad.any(), f"{bad.sum()} entries disagree beyond ties"


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("k", [1, 8])
def test_counted_batch_per_problem_counts(shared, k):
    """A batch whose problems have their own counts (one without a valid
    query, one without a valid point unless the map is shared), through the
    batched front end and through torch.func.vmap of knn_bruteforce: equal
    to the uncounted sweep, and to JAX's knn_bruteforce problem by problem
    within the kNN band."""
    B, Q, C = 4, 150, 331
    rng = np.random.RandomState(20 + k)
    q = rng.uniform(-30, 30, (B, Q, 3)).astype(np.float32)
    p = rng.uniform(-30, 30, (C, 3) if shared else (B, C, 3)).astype(np.float32)
    qv = np.zeros((B, Q), bool)
    for b, n in enumerate((Q, 0, 77, 5)):
        qv[b, :n] = rng.rand(n) > 0.2
    if shared:
        pv = np.zeros(C, bool)
        pv[:C - 40] = rng.rand(C - 40) > 0.25
    else:
        pv = np.zeros((B, C), bool)
        for b, n in enumerate((C, 61, 0, 2)):
            pv[b, :n] = True
    t = [torch.from_numpy(x) for x in (q, qv, p, pv)]
    res = tnb.knn_bruteforce_batched(*t, k=k)
    ref = _uncounted(*t, k)
    for a, e in zip(res, ref):
        assert torch.equal(a, e)
    if shared:
        mapped = torch.func.vmap(lambda qq, vv: tnb.knn_bruteforce(qq, vv, t[2], t[3], k=k))(
            t[0], t[1])
    else:
        mapped = torch.func.vmap(lambda qq, vv, pp, ww: tnb.knn_bruteforce(qq, vv, pp, ww, k=k))(
            *t)
    for a, e in zip(mapped, ref):
        assert torch.equal(a, e)
    for b in range(B):
        pb, pvb = (p, pv) if shared else (p[b], pv[b])
        want = jnb.knn_bruteforce(jnp.asarray(q[b]), jnp.asarray(qv[b]), jnp.asarray(pb),
                                  jnp.asarray(pvb), k=k, backend="xla")
        bad = knn_mismatch(q[b], pb, res.idx[b].numpy(), res.valid[b].numpy(),
                           np.asarray(want.idx), np.asarray(want.dist_sq),
                           np.asarray(want.valid))
        assert not bad.any(), (b, int(bad.sum()))


def test_valid_count_of_a_batch_and_under_vmap():
    mask = torch.zeros(3, 10, dtype=torch.bool)
    mask[0, [1, 7]] = True
    mask[2, :] = True
    assert tnb.valid_count(mask).tolist() == [8, 0, 10]
    assert torch.func.vmap(tnb.valid_count)(mask).tolist() == [8, 0, 10]
    assert tnb.valid_count(torch.zeros(2, 0, dtype=torch.bool)).tolist() == [0, 0]


def test_counts_add_four_ops_to_a_front_end_call():
    """The counts cost two ops per side (a product and an amax, one launch
    each on the card) once the positions of a capacity are cached, and no
    host read: the front end's op count rises by exactly four."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    q, qv, p, pv, _ = _problem(50, 70, seed=3)
    t = [torch.from_numpy(x) for x in (q, qv, p, pv)]
    tnb.valid_count(t[1]), tnb.valid_count(t[3])  # the positions of both capacities
    with Count() as one_side:
        tnb.valid_count(t[1])
    assert [op.split(".")[1] for op in one_side.ops] == ["mul", "amax"]
    with Count() as counted:
        tnb.knn_bruteforce(*t, k=4)
    with Count() as plain:
        q_s = torch.where(t[1][:, None], t[0], 1.0e8).contiguous()
        p_s = torch.where(t[3][:, None], t[2], -1.0e8).contiguous()
        tnb._result(*tnb._sweep_op(q_s, p_s, 4, tnb.STREAM_BLOCK, None, None), 70, None)
    assert len(counted.ops) == len(plain.ops) + 4
    assert not any("item" in op or "_local_scalar" in op for op in counted.ops)


def test_count_arguments_are_checked():
    q = torch.zeros(4, 3)
    d, i = tnb.knn_sweep(q, q, 2, torch.tensor(9, dtype=torch.int32),
                         torch.tensor(-3, dtype=torch.int32))  # clamped to [0, rows]
    assert torch.isinf(d).all() and (i == -1).all()
    d, i = tnb.knn_sweep_batched(q.expand(2, 4, 3), q, 1,
                                 torch.tensor([1, 3], dtype=torch.int32))
    assert (i[0, 1:] == -1).all() and (i[1, :3] == 0).all() and (i[1, 3:] == -1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_one_to_one_matches_jax(seed):
    rng = np.random.RandomState(seed)
    Q, G = 500, 60
    idx = rng.randint(0, G, (Q, 1)).astype(np.int32)
    # coarse distances force many exact ties: the lowest row must win them
    d = rng.randint(0, 5, (Q, 1)).astype(np.float32) * 0.25
    valid = rng.rand(Q, 1) > 0.2
    ref = jnn.resolve_one_to_one(jnp.asarray(idx), jnp.asarray(d), jnp.asarray(valid), G)
    got = tnn.resolve_one_to_one(torch.from_numpy(idx), torch.from_numpy(d),
                                 torch.from_numpy(valid), G)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_kernel_matches_knn_plain_on_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kNN kernel has no CPU mode")
    q, qv, p, pv, _ = _problem(777, 3001, seed=k)
    qd, pd = torch.from_numpy(q).cuda(), torch.from_numpy(p).cuda()
    d_ref, i_ref = tnb.knn_plain(qd, pd, k)
    d, i = tnb.knn_sweep(qd, pd, k)
    torch.cuda.synchronize()
    ok = np.ones((777, k), bool)
    bad = knn_mismatch(q, p, i.cpu().numpy(), ok, i_ref.cpu().numpy(),
                       d_ref.cpu().numpy(), ok, tol=TIE_TOL)
    assert not bad.any()
    # direct (q - p)² with the same rounding: equal to the plain version
    assert torch.equal(d, d_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_counted_kernel_matches_counted_knn_plain_on_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kNN kernel has no CPU mode")
    rng = np.random.RandomState(k)
    q = torch.from_numpy(rng.randint(0, 6, (777, 3)).astype(np.float32)).cuda()
    p = torch.from_numpy(rng.randint(0, 6, (3001, 3)).astype(np.float32)).cuda()
    for n_q, n_p in ((777, 3001), (500, 1234), (1, 1), (0, 77), (300, 0), (33, 3)):
        counts = (torch.tensor(n_q, dtype=torch.int32, device="cuda"),
                  torch.tensor(n_p, dtype=torch.int32, device="cuda"))
        d, i = tnb.knn_sweep(q, p, k, *counts)
        d_ref, i_ref = tnb.knn_plain(q, p, k, *counts)
        assert torch.equal(d, d_ref) and torch.equal(i, i_ref), (n_q, n_p)
