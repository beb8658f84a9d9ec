"""The Gauss-Newton solve as one kernel (``csrc/gn_solve.cu``) and the rule
that routes a solve to it.

On the CPU:

- ``takes_kernel``: the kernel for a solve on the card whose live blocks
  lie within {pt2pt, pt2pl}, with no robust kernel and no prior; the plain
  float64 path for everything else;
- ``Pairings.live`` is static pytree data: ``vmap``, ``tree_map``,
  ``decimated``, ``stack_records`` and the batch's ``_where`` keep it, and
  ``ICP._run_matchers`` sets it from the matchers' blocks;
- the wrapper, the custom operator and its vmap rule hand the kernel the
  right blocks, weights, strides and shapes: with the launch replaced by
  the plain path run problem by problem, a solve equals the plain path's
  to the bit, one problem or a batch, a shared (unbatched) block included;
  without a card the wrapper raises.

Against the JAX package: the plain path on the CPU and the kernel on the
card, at the cells' shapes, to the JAX package's poses for the same inputs
(``scripts/torch_gn_reference.json``).

On the card (the ``cuda`` marker; skipped without one): the kernel against
the plain path at the cells' shapes, a singular H, no valid rows, a batch
against its single launches and two runs bit for bit, the launch count,
and the batched align and the fleet against their sequential runs.

This file imports no JAX, so its card cases run with ``python -m pytest
tests/test_torch_gn_kernel.py -m cuda --noconftest``.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.func import vmap

import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pairings import (
    ALL_BLOCKS,
    Pairings,
    PairsPt2Pl,
    PairsPt2Pt,
)
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.eval.gn_problem import gn_problem
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters, stack_records
from mp2p_icp_tpu_torch.matchers import (
    LayerMatch,
    MatcherAdaptive,
    MatcherPoint2Line,
    MatcherPoint2Plane,
    MatcherPointsDistanceThreshold,
)
from mp2p_icp_tpu_torch.ops import cuda_build
from mp2p_icp_tpu_torch.parallel import batch, make_batched_align, stack_pytrees
from mp2p_icp_tpu_torch.solvers import gauss_newton as gn
from mp2p_icp_tpu_torch.solvers.common import PairWeights
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams, SE3Prior
from mp2p_icp_tpu_torch.solvers.robust import RobustKernel
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn, solve_in_f64
from mp2p_icp_tpu_torch.utils import profiler


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU (the card cases pass their device) and say so once for the file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


# ------------------------------------------------------------------ inputs
def _plain(pairings, guess, params):
    """The plain path of SolverGaussNewton: float64 PyTorch over all five
    blocks, the pose rounded once."""
    return solve_in_f64(lambda p, g, pr: gn.optimal_tf_gauss_newton(p, g, params, pr),
                        pairings, guess)


def _stack(trees):
    return pytree.tree_map(lambda *xs: torch.stack(xs), *trees)


# ------------------------------------------------------------ the rule (CPU)
LIVE_SETS = {
    "pt2pt": {"pt2pt"}, "pt2pl": {"pt2pl"}, "pt2pt+pt2pl": {"pt2pt", "pt2pl"},
    "none": set(), "pt2ln": {"pt2ln"}, "pt2pt+pt2ln": {"pt2pt", "pt2ln"},
    "pl2pl": {"pl2pl"}, "ln2ln": {"ln2ln"}, "all": set(ALL_BLOCKS),
}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("with_prior", [False, True], ids=["no_prior", "prior"])
@pytest.mark.parametrize("kernel", [RobustKernel.NONE, RobustKernel.CAUCHY],
                         ids=["no_kernel", "cauchy"])
@pytest.mark.parametrize("live", list(LIVE_SETS), ids=list(LIVE_SETS))
def test_takes_kernel(live, kernel, with_prior, device):
    """The kernel exactly where every condition holds; a torch.device is
    made without a card, so the rule is tested here for both devices."""
    prior = SE3Prior(mean=se3.identity(), inv_cov=torch.eye(6)) if with_prior else None
    want = (device == "cuda" and LIVE_SETS[live] <= {"pt2pt", "pt2pl"}
            and kernel == RobustKernel.NONE and not with_prior)
    assert gn.takes_kernel(frozenset(LIVE_SETS[live]), torch.device(device), kernel,
                           prior) is want


def test_cpu_solves_take_the_plain_path_and_are_counted():
    """A CPU solve never launches; under a trace each solve leaves one
    ``gn.solve`` record: ("plain", None, rows of its live blocks)."""
    pairings, guess = gn_problem(0, n_pt=64, n_pl=32)
    before = cuda_build.launches["gn_solve"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = SolverGaussNewton().solve(pairings, guess)
        records = [v for name, v in profiler.drain_counts() if name == "gn.solve"]
    assert cuda_build.launches["gn_solve"] == before
    assert records == [("plain", None, 96)]
    want = _plain(pairings, guess, GNParams())
    assert torch.equal(out.R, want.R) and torch.equal(out.t, want.t)


# ---------------------------------------------------- the live set (CPU)
def test_live_set_survives_the_pytree_transforms():
    pairings, _ = gn_problem(1, n_pt=16)
    live = frozenset({"pt2pt"})
    assert pairings.live == live
    assert pytree.tree_map(lambda x: x, pairings).live == live
    assert pairings.decimated(4).live == live
    stacked = _stack([pairings, pairings])
    assert stacked.live == live
    assert vmap(lambda p: p)(stacked).live == live
    assert vmap(lambda p: p.decimated(4))(stacked).live == live
    mask = torch.tensor([True, False])
    assert batch._where(mask, stacked, stacked).live == live
    recorded = stack_records([(se3.identity(), pairings.size(), pairings.decimated(4))] * 3)
    assert recorded["iteration_pairings"].live == live
    # the set is the pytree's context, not a leaf
    leaves, spec = pytree.tree_flatten(pairings)
    assert all(isinstance(x, torch.Tensor) for x in leaves)
    assert pytree.tree_unflatten(leaves, spec).live == live
    other = dataclasses.replace(pairings, live=ALL_BLOCKS)
    assert pytree.tree_structure(other) != spec
    assert Pairings.empty().live == ALL_BLOCKS


def _layers(rng, n, cap):
    xyz = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    return {"raw": PointCloud.from_numpy(xyz, capacity=cap)}


@pytest.mark.parametrize("matchers, live", [
    ([MatcherPoint2Plane(distance_threshold=2.0)], {"pt2pl"}),
    ([MatcherPointsDistanceThreshold(threshold=2.0)], {"pt2pt"}),
    ([MatcherAdaptive()], {"pt2pt", "pt2pl"}),
    ([MatcherPoint2Line(distance_threshold=2.0)], {"pt2ln"}),
    ([MatcherPointsDistanceThreshold(threshold=2.0),
      MatcherPoint2Plane(distance_threshold=2.0, layer_matches=(LayerMatch(),))],
     {"pt2pt", "pt2pl"}),
], ids=["point2plane", "distance_threshold", "adaptive", "point2line", "two_matchers"])
@pytest.mark.parametrize("active", [True, False], ids=["active", "inactive"])
def test_run_matchers_sets_the_live_blocks(matchers, live, active):
    """The set of block types that the align's matchers emit, the same
    whether or not they run in the iteration."""
    rng = np.random.RandomState(3)
    icp = ICP(matchers=matchers, solvers=[SolverGaussNewton()])
    g, l = _layers(rng, 300, 512), _layers(rng, 200, 256)
    out = icp._run_matchers([active] * len(matchers), g, l, se3.identity(), 0)
    assert out.live == frozenset(live)
    for name in ALL_BLOCKS - frozenset(live):
        block = getattr(out, name)
        assert block.capacity in (1, 8) and not block.valid().any()


# ------------------------------------------- the wrapper's plumbing (CPU)
def _emulated_launch(kernel, dev, B, args, _B, iterations, min_delta, max_cost, damping,
                     w_pt, w_pl, out_R, out_t):
    """``cuda_build.launch`` of the Gauss-Newton kernel with the kernel
    replaced by the plain path, problem by problem, reading the arguments
    as the kernel does."""
    assert kernel.library == "gn_solve" and _B == B
    def nth(a, b):
        return None if a is None else (a[0][b] if a[1] else a[0])

    params = GNParams(max_iterations=iterations, min_delta=min_delta, max_cost=max_cost,
                      damping=damping, pair_weights=PairWeights(pt2pt=w_pt, pt2pl=w_pl))
    out_R, out_t = out_R.view(B, 3, 3), out_t.view(B, 3)
    for b in range(B):
        x = [nth(a, b) for a in args]
        blocks = {}
        if x[0] is not None:
            n = x[2].shape[0]
            blocks["pt2pt"] = PairsPt2Pt(local=x[0], globl=x[1], weight=x[2],
                                         local_idx=torch.zeros(n, dtype=torch.int32),
                                         global_idx=torch.zeros(n, dtype=torch.int32))
        if x[3] is not None:
            blocks["pt2pl"] = PairsPt2Pl(local=x[3], plane_centroid=x[4], plane_normal=x[5],
                                         weight=x[6],
                                         local_idx=torch.zeros(x[6].shape[0], dtype=torch.int32))
        pose = _plain(dataclasses.replace(Pairings.empty(), **blocks), se3.Pose(x[7], x[8]),
                      params)
        out_R[b], out_t[b] = pose.R, pose.t
    cuda_build.launches["gn_solve"] += 1


PARAMS = GNParams(max_iterations=3, pair_weights=PairWeights(pt2pt=0.5, pt2pl=2.0))


@pytest.mark.parametrize("blocks", [(96, 0), (0, 80), (96, 80)],
                         ids=["pt2pt", "pt2pl", "adaptive"])
def test_wrapper_hands_the_kernel_its_blocks(monkeypatch, blocks):
    """One problem and a vmapped batch of three, through the custom
    operator and its vmap rule: equal to the plain path to the bit, so the
    blocks, weights and pose reach the kernel in its argument order."""
    monkeypatch.setattr(cuda_build, "launch", _emulated_launch)
    problems = [gn_problem(s, *blocks) for s in (4, 5, 6)]
    pairings, guess = problems[0]
    one = gn.gn_solve_fused(pairings, guess, PARAMS)
    want = _plain(pairings, guess, PARAMS)
    assert torch.equal(one.R, want.R) and torch.equal(one.t, want.t)
    assert one.R.shape == (3, 3) and one.t.shape == (3,)

    before = cuda_build.launches["gn_solve"]
    out = vmap(lambda p, g: gn.gn_solve_fused(p, g, PARAMS))(
        _stack([p for p, _ in problems]), _stack([g for _, g in problems]))
    assert cuda_build.launches["gn_solve"] == before + 1  # one launch for the batch
    for b, (p, g) in enumerate(problems):
        want = _plain(p, g, PARAMS)
        assert torch.equal(out.R[b], want.R) and torch.equal(out.t[b], want.t)


def test_vmap_rule_shares_an_unbatched_input(monkeypatch):
    """One set of pairings and three guesses: the pairings go to the kernel
    once with stride 0, and each problem is the single solve at its guess."""
    calls = []

    def launch(kernel, dev, B, args, *rest):
        calls.append([None if a is None else a[1] for a in args])
        _emulated_launch(kernel, dev, B, args, *rest)

    monkeypatch.setattr(cuda_build, "launch", launch)
    pairings, guess = gn_problem(7, n_pl=40)
    guesses = [se3.compose(guess, se3.from_xyz_ypr(0.01 * b, 0, 0, 0, 0, 0)) for b in range(3)]
    out = vmap(lambda g: gn.gn_solve_fused(pairings, g, PARAMS))(_stack(guesses))
    assert calls == [[None, None, None, False, False, False, False, True, True]]
    for b, g in enumerate(guesses):
        want = _plain(pairings, g, PARAMS)
        assert torch.equal(out.R[b], want.R) and torch.equal(out.t[b], want.t)


def test_solver_routes_to_the_kernel_where_the_rule_says(monkeypatch):
    """SolverGaussNewton.solve calls the fused wrapper exactly where
    ``takes_kernel`` holds (the rule forced here: a CPU tensor otherwise
    never reaches it), with the iteration's kernel_param resolved."""
    monkeypatch.setattr(cuda_build, "launch", _emulated_launch)
    monkeypatch.setattr("mp2p_icp_tpu_torch.solvers.solver.takes_kernel",
                        lambda live, device, kernel, prior: live <= gn.FUSED_BLOCKS)
    pairings, guess = gn_problem(8, n_pt=50, n_pl=50)
    before = cuda_build.launches["gn_solve"]
    out = SolverGaussNewton(gn_params=PARAMS).solve(pairings, guess)
    assert cuda_build.launches["gn_solve"] == before + 1
    want = _plain(pairings, guess, PARAMS)
    assert torch.equal(out.R, want.R) and torch.equal(out.t, want.t)
    SolverGaussNewton(gn_params=PARAMS).solve(dataclasses.replace(pairings, live=ALL_BLOCKS),
                                              guess)
    assert cuda_build.launches["gn_solve"] == before + 1


def test_wrapper_raises_without_a_card():
    pairings, guess = gn_problem(9, n_pt=8)
    with pytest.raises(ValueError, match="runs on the card"):
        gn.gn_solve_fused(pairings, guess, PARAMS)


# -------------------------------------------------------------- on the card
def _f32_ulps(a, b):
    """Units in the last place between two float32 tensors, elementwise
    (0 and -0 count as equal)."""
    ia = torch.where(a == 0, 0.0, a).view(torch.int32).long()
    ib = torch.where(b == 0, 0.0, b).view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(0, 6144), (8192, 0), (8192, 8192)],
                         ids=["pt2pl_6144", "pt2pt_8192", "adaptive_8192"])
def test_kernel_matches_the_plain_path(blocks):
    """The cells' shapes: the odometry's 6,144-row pt2pl block, the scan's
    8,192-row pt2pt block, Adaptive's mixed blocks. Tolerance: 1 float32
    ulp per element. Both sum in float64, in different orders, so the
    float64 poses differ in the last bits (~1e-16 relative), and the one
    rounding to float32 may fall on either side where a value lies within
    that of a rounding boundary; a wrong term would move the pose by far
    more."""
    dev = _card()
    for seed in range(4):
        pairings, guess = gn_problem(10 + seed, *blocks)
        want = _plain(pairings, guess, PARAMS)
        p, g = pytree.tree_map(lambda x: x.to(dev), (pairings, guess))
        got = gn.gn_solve_fused(p, g, PARAMS)
        assert int(_f32_ulps(got.R.cpu(), want.R).max()) <= 1
        assert int(_f32_ulps(got.t.cpu(), want.t).max()) <= 1
        assert float(se3.error_log_norm(want, guess)) > 1e-3  # the solve moved the pose


JAX_REFERENCE = Path(__file__).resolve().parents[1] / "scripts" / "torch_gn_reference.json"


@pytest.mark.parametrize("path", ["plain", pytest.param("kernel", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("blocks", [(0, 6144), (8192, 0), (8192, 8192)],
                         ids=["pt2pl_6144", "pt2pt_8192", "adaptive_8192"])
def test_solve_matches_the_jax_package(blocks, path):
    """The plain path (on the CPU) and the kernel (on the card) against the
    JAX package's float32 ``optimal_tf_gauss_newton`` on the same inputs,
    at the cells' shapes: ``scripts/torch_gn_reference.json``, which
    tests/test_torch_solvers.py holds to the JAX package on the CPU, as
    this file runs on the card without JAX. Tolerance: R within 1e-5, the
    band of test_torch_solvers.py's solver parity tests; t within 1e-5 of
    |t|, that band scaled by the translation, since the JAX package sums
    in float32 and 150 m from the origin one float32 ulp of t is already
    1.5e-5 (the plain path's largest gap here is 1.2e-4 of 157 m, in the
    mixed case)."""
    ref = json.loads(JAX_REFERENCE.read_text())
    assert ref["params"] == {"max_iterations": PARAMS.max_iterations,
                             "pt2pt": PARAMS.pair_weights.pt2pt,
                             "pt2pl": PARAMS.pair_weights.pt2pl}
    dev = _card() if path == "kernel" else torch.device("cpu")
    cases = [c for c in ref["cases"] if (c["n_pt"], c["n_pl"]) == blocks]
    assert len(cases) == 4
    for c in cases:
        pairings, guess = gn_problem(c["seed"], c["n_pt"], c["n_pl"], device=dev)
        got = (gn.gn_solve_fused(pairings, guess, PARAMS) if path == "kernel"
               else _plain(pairings, guess, PARAMS))
        R, t = torch.tensor(c["R"]).view(3, 3), torch.tensor(c["t"])
        torch.testing.assert_close(got.R.cpu(), R, atol=1e-5, rtol=0)
        torch.testing.assert_close(got.t.cpu(), t, atol=1e-5 * float(t.norm()), rtol=0)


@pytest.mark.cuda
def test_kernel_keeps_the_pose_on_a_singular_H():
    """Every normal along z and no damping: H has zero rows (tx, ty, rz),
    the factorisation fails, the step is NaN and taken as 0, and the pose
    comes back as it went in, as on the plain path."""
    dev = _card()
    pairings, guess = gn_problem(20, n_pl=512)
    pl = pairings.pt2pl
    n = torch.zeros_like(pl.plane_normal)
    n[:, 2] = 1.0
    pairings = dataclasses.replace(pairings, pt2pl=dataclasses.replace(pl, plane_normal=n))
    guess = se3.Pose(torch.eye(3), guess.t)
    params = GNParams(damping=0.0)
    want = _plain(pairings, guess, params)
    assert torch.equal(want.R, guess.R) and torch.equal(want.t, guess.t)
    got = gn.gn_solve_fused(*pytree.tree_map(lambda x: x.to(dev), (pairings, guess)), params)
    assert torch.equal(got.R.cpu(), guess.R) and torch.equal(got.t.cpu(), guess.t)


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [(0, 6144), (8192, 0)], ids=["pt2pl", "pt2pt"])
def test_kernel_without_valid_rows_keeps_the_guess(blocks):
    dev = _card()
    pairings, guess = gn_problem(21, *blocks, valid=0.0)
    want = _plain(pairings, guess, PARAMS)
    got = gn.gn_solve_fused(*pytree.tree_map(lambda x: x.to(dev), (pairings, guess)), PARAMS)
    for a, b in ((got.R.cpu(), want.R), (got.t.cpu(), want.t), (want.R, guess.R),
                 (want.t, guess.t)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_batch_equals_single_launches_and_runs_repeat():
    """8 problems in one launch equal their 8 single launches bit for bit
    (one block each, one summation order whatever B); a second run of the
    batch equals the first; one launch per solve, one for the batch."""
    dev = _card()
    problems = [pytree.tree_map(lambda x: x.to(dev), gn_problem(30 + b, n_pl=6144))
                for b in range(8)]
    before = cuda_build.launches["gn_solve"]
    singles = [gn.gn_solve_fused(p, g, PARAMS) for p, g in problems]
    assert cuda_build.launches["gn_solve"] == before + 8
    P, G = _stack([p for p, _ in problems]), _stack([g for _, g in problems])
    runs = [vmap(lambda p, g: gn.gn_solve_fused(p, g, PARAMS))(P, G) for _ in range(2)]
    assert cuda_build.launches["gn_solve"] == before + 10
    for out in runs:
        for b, one in enumerate(singles):
            assert torch.equal(out.R[b], one.R) and torch.equal(out.t[b], one.t)
    again = gn.gn_solve_fused(*problems[3], PARAMS)
    assert torch.equal(again.R, singles[3].R) and torch.equal(again.t, singles[3].t)


@pytest.mark.cuda
@pytest.mark.parametrize("horn_up_to", [2, -1], ids=["horn_then_gn", "gn"])
@pytest.mark.parametrize("broadcast", [True, False])
def test_batched_align_equals_sequential_on_the_card(broadcast, horn_up_to):
    """test_torch_batch.py's batched align on the card, with its
    tolerances: each problem's pose within 1e-5 of its sequential align,
    the same iterations, termination and final pairs. Its schedule (Horn
    to iteration 2, then Gauss-Newton on pt2pt) stalls before the third
    iteration here, so a second one runs Gauss-Newton, the kernel, from
    the first."""
    dev = _card()
    rng = np.random.RandomState(11)
    scene = rng.uniform(-40, 40, (4096, 3)).astype(np.float32)
    locals_ = []
    for b in range(3):
        center = scene[rng.randint(0, scene.shape[0])]
        pts = scene[np.linalg.norm(scene - center, axis=1) < 25.0][:512]
        gt = se3.from_xyz_ypr(0.3 + 0.1 * b, -0.2, 0.1, 0.04, -0.02, 0.01, device="cpu")
        locals_.append(se3.apply(se3.inverse(gt), torch.from_numpy(pts)).numpy())
    icp = ICP(matchers=[MatcherPointsDistanceThreshold(threshold=2.0)],
              solvers=[SolverHorn(enabled=horn_up_to >= 0, run_up_to_iteration=horn_up_to),
                       SolverGaussNewton(run_from_iteration=horn_up_to + 1,
                                         gn_params=GNParams(max_iterations=2))])
    params = ICPParameters(max_iterations=10, crop_capacity=2048, crop_extra_margin=2.0)
    gmap = {"raw": PointCloud.from_numpy(scene, capacity=4096, device=dev)}
    l_t = [{"raw": PointCloud.from_numpy(x, capacity=512, device=dev)} for x in locals_]
    before = cuda_build.launches["gn_solve"]
    res = make_batched_align(icp, params, broadcast_globals=broadcast)(
        stack_pytrees(l_t), gmap if broadcast else stack_pytrees([gmap] * 3),
        stack_pytrees([se3.identity(device=dev)] * 3))
    gn_ran = int(res.n_iterations.max()) > horn_up_to + 1
    assert (cuda_build.launches["gn_solve"] > before) == gn_ran
    assert horn_up_to >= 0 or gn_ran
    for b in range(3):
        seq = icp.align(l_t[b], gmap, se3.identity(device=dev), params)
        torch.testing.assert_close(res.optimal_tf.R[b], seq.optimal_tf.R, atol=1e-5, rtol=0)
        torch.testing.assert_close(res.optimal_tf.t[b], seq.optimal_tf.t, atol=1e-5, rtol=0)
        assert torch.equal(res.final_pairings.pt2pt.global_idx[b],
                           seq.final_pairings.pt2pt.global_idx)
        assert int(res.n_iterations[b]) == seq.n_iterations
        assert int(res.termination_reason[b]) == seq.termination_reason


@pytest.mark.cuda
def test_fleet_equals_the_sequential_runs_on_the_card():
    """test_torch_fleet.py's contract on the card, at bench_torch.py's
    odometry configuration cut by 4, with its tolerances: each stream of a
    fleet of 2 equals its sequential run (R and t within 1e-5, iterations,
    map counts and map rows equal)."""
    dev = _card()
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import bench_torch
    from mp2p_icp_tpu_torch.eval.lidar_sim import make_street_sequence
    from mp2p_icp_tpu_torch.odometry import BatchedOdometryMapper

    mp2p_icp_tpu_torch.set_default_device(dev)
    try:
        gt, twists, scans = make_street_sequence(9, n_rings=16, n_azimuth=512)
        frames = bench_torch.odometry_frames(scans, capacity=1 << 13)
        mapper = bench_torch.odometry_mapper(scale=4)
        cut = [(0, 6), (3, 9)]
        poses = [se3.Pose(torch.as_tensor(gt[a, :3, :3], dtype=torch.float32, device=dev),
                          torch.as_tensor(gt[a, :3, 3], dtype=torch.float32, device=dev))
                 for a, _ in cut]
        before = cuda_build.launches["gn_solve"]
        fleet = BatchedOdometryMapper(mapper).run(
            [frames[a:b] for a, b in cut], twists=[twists[a:b] for a, b in cut],
            initial_poses=poses, dt=0.1)
        assert cuda_build.launches["gn_solve"] > before
        for i, (a, b) in enumerate(cut):
            seq = mapper.run(frames[a:b], twists=twists[a:b], initial_pose=poses[i], dt=0.1)
            assert np.abs(fleet["poses"][i] - seq["poses"]).max() <= 1e-5
            np.testing.assert_array_equal(fleet["iterations"][i], seq["iterations"])
            np.testing.assert_array_equal(fleet["map_counts"][i], seq["map_counts"])
            assert torch.equal(fleet["maps"].xyz[i], seq["map"].xyz)
    finally:
        mp2p_icp_tpu_torch.set_default_device("cpu")
