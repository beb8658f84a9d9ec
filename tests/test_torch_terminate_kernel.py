"""The ICP loop's termination test as one kernel (``csrc/icp_terminate.cu``)
and the rule that routes a test to it.

On the CPU:

- ``takes_kernel``: the kernel where the three poses and the live blocks'
  weights lie on the card in float32; the plain path for everything else,
  whose flags and pose equal the formulas ``ICP._step`` has always used, to
  the bit, on the CPU in float32 and float64;
- the wrapper, the custom operator and its vmap rule hand the kernel the
  right poses, weights, strides and shapes: with the launch replaced by the
  plain path run problem by problem, a test equals the plain path's to the
  bit, one problem or a batch, shared (unbatched) poses and pairings
  included; ``ICP.align`` and the batched align routed through it equal
  their plain runs, one launch an ICP iteration; without a card the wrapper
  raises.

On the card (the ``cuda`` marker; skipped without one): the kernel against
``se3.delta_norms`` and the plain flags and pose over 100,000 pose triples
(angles near 0 and near pi, rotations by pi, identical poses, NaN and inf in
the solver's pose, no pairs, NaN and negative weights), dt and dr to the
bit; the stall flag with a threshold at a step norm and 1 ulp either side;
a batch against its single launches; the align, the batched align, the
odometry and the fleet against their runs on the plain path: poses,
iterations and termination reasons equal.

This file imports no JAX, so its card cases run with ``python -m pytest
tests/test_torch_terminate_kernel.py -m cuda --noconftest``.
"""

import dataclasses
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree
from torch.func import vmap

import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pairings import BLOCK_TYPES, Pairings
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters
from mp2p_icp_tpu_torch.matchers import MatcherPointsDistanceThreshold
from mp2p_icp_tpu_torch.ops import cuda_build
from mp2p_icp_tpu_torch.ops import icp_terminate as term
from mp2p_icp_tpu_torch.parallel import make_batched_align, stack_pytrees
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn
from mp2p_icp_tpu_torch.utils import profiler

EPS_T, EPS_R = 5e-4, 1e-4  # ICPParameters' defaults


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
def _pairings(weights: dict) -> Pairings:
    """Pairings whose live blocks are ``weights``' keys, each with those
    weights (the rest of its fields empty), every other block a
    placeholder."""
    device = next(iter(weights.values())).device
    blocks = {name: dataclasses.replace(BLOCK_TYPES[name].empty(w.shape[-1], device),
                                        weight=w)
              for name, w in weights.items()}
    return dataclasses.replace(Pairings.empty(device=device), **blocks,
                               live=frozenset(weights))


def _triples(rng: np.random.RandomState, kinds, dtype=torch.float32):
    """(pose, prev_pose, new_pose), each batched over ``kinds``, one kind of
    step each: ``random``, ``small`` (the solver's step near 0),
    ``near_pi`` (a relative rotation near or at pi), ``same`` (new_pose
    equal to pose), ``stall2`` (new_pose equal to prev_pose), ``nan`` /
    ``inf`` (one component of new_pose not finite). Drawn in float64,
    rounded to ``dtype``."""
    kinds = np.asarray(kinds)
    n = len(kinds)

    def rotation(angles):
        axis = rng.randn(n, 3)
        axis /= np.linalg.norm(axis, axis=1, keepdims=True)
        return se3.so3_exp(torch.as_tensor(axis * np.asarray(angles)[:, None]))

    def step(angle_scale, trans_scale):
        return se3.exp(torch.as_tensor(np.concatenate(
            [rng.randn(n, 3) * trans_scale[:, None], rng.randn(n, 3) * angle_scale[:, None]],
            axis=1)))

    def where(mask, p, q):
        m = torch.as_tensor(mask)
        return Pose(torch.where(m[:, None, None], p.R, q.R), torch.where(m[:, None], p.t, q.t))

    a = Pose(rotation(rng.uniform(0, math.pi, n)), torch.as_tensor(rng.uniform(-50, 50, (n, 3))))
    wide = np.full(n, 0.05), np.full(n, 0.3)
    prev = se3.compose(a, step(*wide))
    small = kinds == "small"
    d = step(np.where(small, 10.0 ** rng.uniform(-9, -3, n), wide[0]),
             np.where(small, 10.0 ** rng.uniform(-9, -2, n), wide[1]))
    off = np.where(rng.rand(n) < 0.3, 0.0, 10.0 ** rng.uniform(-7, -1, n))
    flip = Pose(rotation(math.pi - off), torch.as_tensor(rng.randn(n, 3)))
    new = se3.compose(a, where(kinds == "near_pi", flip, d))
    a, prev, new = (Pose(p.R.to(dtype), p.t.to(dtype)) for p in (a, prev, new))
    new = where(kinds == "same", a, where(kinds == "stall2", prev, new))
    flat = torch.cat([new.R.reshape(n, 9), new.t], dim=1)
    for b in np.flatnonzero((kinds == "nan") | (kinds == "inf")):
        flat[b, rng.randint(12)] = (math.nan if kinds[b] == "nan"
                                    else rng.choice([math.inf, -math.inf]))
    return a, prev, Pose(flat[:, :9].reshape(n, 3, 3), flat[:, 9:])


def _triple(rng, kind, dtype=torch.float32):
    """One triple of ``_triples``."""
    return tuple(Pose(p.R[0], p.t[0]) for p in _triples(rng, [kind], dtype))


def _weights(rng, n, kind="some", dtype=torch.float32):
    """[n] weights: ``some`` valid, ``none`` (all 0), ``odd`` (only NaN,
    negative and 0: no valid row)."""
    if kind == "none":
        return torch.zeros(n, dtype=dtype)
    if kind == "odd":
        return torch.as_tensor(rng.choice([math.nan, -1.0, 0.0, -0.0], n), dtype=dtype)
    return torch.as_tensor(np.where(rng.rand(n) < 0.5, rng.uniform(0.1, 2.0, n), 0.0),
                           dtype=dtype)


def _formula(pairings, pose, prev_pose, new_pose, eps_t, eps_r):
    """``ICP._step``'s termination test as it was written before the kernel:
    (no_pairs, solver_ok, stalled, the kept pose)."""
    no_pairs = pairings.size() == 0
    solver_ok = torch.isfinite(new_pose.t).all() & torch.isfinite(new_pose.R).all()
    dt1, dr1 = se3.delta_norms(pose, new_pose)
    dt2, dr2 = se3.delta_norms(prev_pose, new_pose)
    stalled = ((dt1 < eps_t) & (dr1 < eps_r)) | ((dt2 < eps_t) & (dr2 < eps_r))
    keep_new = solver_ok & ~no_pairs
    return no_pairs, solver_ok, stalled, Pose(torch.where(keep_new, new_pose.R, pose.R),
                                              torch.where(keep_new, new_pose.t, pose.t))


def _same(a, b):
    """Bit for bit, NaN where NaN (of any payload)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and torch.equal(a[~nan], b[~nan])


# ------------------------------------------------------------ the rule (CPU)
def _stand_in(device, dtype):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("odd_one", [None, "pose", "prev_pose", "new_pose", "weight"])
def test_takes_kernel(device, odd_one):
    """The kernel exactly where every tensor lies on the card in float32; a
    torch.device is made without a card, so the rule is tested here for
    both devices (stand-ins carry the device and type it reads)."""
    def x(name):
        return _stand_in(device, torch.float64 if name == odd_one else torch.float32)

    poses = [Pose(x(name), x(name)) for name in ("pose", "prev_pose", "new_pose")]
    block = types.SimpleNamespace(weight=x("weight"))
    pairings = types.SimpleNamespace(live=frozenset({"pt2pl"}), pt2pl=block)
    assert term.takes_kernel(pairings, *poses) is (device == "cuda" and odd_one is None)


KINDS = ("random", "small", "near_pi", "same", "stall2", "nan", "inf")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("pairs", ["some", "none", "odd"])
@pytest.mark.parametrize("kind", KINDS)
def test_cpu_takes_the_plain_path_equal_to_the_formulas(kind, pairs, dtype):
    """A CPU test never launches, leaves one ("plain", None) record under a
    trace, and gives the flags and pose of the formulas to the bit."""
    rng = np.random.RandomState(KINDS.index(kind) * 10 + len(pairs))
    pose, prev, new = _triple(rng, kind, dtype)
    pairings = _pairings({"pt2pt": _weights(rng, 40, pairs), "pt2pl": _weights(rng, 24, pairs)})
    before = cuda_build.launches["icp_terminate"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got, flags = term.terminate(pairings, pose, prev, new, EPS_T, EPS_R)
        records = [v for name, v in profiler.drain_counts() if name == "icp.terminate"]
    assert cuda_build.launches["icp_terminate"] == before
    assert records == [("plain", None)]
    no_pairs, solver_ok, stalled, want = _formula(pairings, pose, prev, new, EPS_T, EPS_R)
    assert flags.dtype == torch.bool and flags.tolist() == [bool(no_pairs), bool(solver_ok),
                                                            bool(stalled)]
    assert torch.equal(got.R, want.R) and torch.equal(got.t, want.t)
    assert bool(no_pairs) == (pairs != "some")
    assert bool(solver_ok) == (kind not in ("nan", "inf"))
    if kind in ("same", "stall2"):
        assert bool(stalled)


# ------------------------------------------- the wrapper's plumbing (CPU)
def _emulated_launch(kernel, dev, B, args, _B, eps_t, eps_r, out_R, out_t, out_flags,
                     out_norms):
    """``cuda_build.launch`` of the termination kernel with the kernel
    replaced by the plain path, problem by problem, reading the arguments
    as the kernel does."""
    assert kernel.library == "icp_terminate" and _B == B
    def nth(a, b):
        return None if a is None else (a[0][b] if a[1] else a[0])

    out_R, out_t = out_R.view(B, 3, 3), out_t.view(B, 3)
    out_flags, out_norms = out_flags.view(B, 3), out_norms.view(B, 4)
    for b in range(B):
        x = [nth(a, b) for a in args]
        pairings = _pairings({name: w for name, w in zip(BLOCK_TYPES, x[6:]) if w is not None})
        pose, prev, new = Pose(x[0], x[1]), Pose(x[2], x[3]), Pose(x[4], x[5])
        kept, flags = term.terminate_plain(pairings, pose, prev, new, eps_t, eps_r)
        out_R[b], out_t[b], out_flags[b] = kept.R, kept.t, flags
        out_norms[b] = torch.stack([*se3.delta_norms(pose, new), *se3.delta_norms(prev, new)])
    cuda_build.launches["icp_terminate"] += 1


def _problems(seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for b in range(n):
        kind = KINDS[b % len(KINDS)]
        pairs = "none" if b % 5 == 4 else "some"
        out.append((_pairings({"pt2pt": _weights(rng, 32, pairs),
                               "pt2pl": _weights(rng, 48, pairs)}), *_triple(rng, kind)))
    return out


def _plain(problem):
    kept, flags = term.terminate_plain(*problem, EPS_T, EPS_R)
    _, prev, new = problem[1:]
    norms = torch.stack([*se3.delta_norms(problem[1], new), *se3.delta_norms(prev, new)])
    return kept, flags, norms


def _equal(got, want):
    (gp, gf, gn), (wp, wf, wn) = got, want
    return (torch.equal(gp.R, wp.R) and torch.equal(gp.t, wp.t) and torch.equal(gf, wf)
            and _same(gn, wn))


def _stack(trees):
    return pytree.tree_map(lambda *xs: torch.stack(xs), *trees)


def test_wrapper_hands_the_kernel_its_inputs(monkeypatch):
    """One problem and a vmapped batch of seven, through the custom
    operator and its vmap rule: equal to the plain path to the bit, so the
    poses, weights and thresholds reach the kernel in its argument order;
    one launch for the batch."""
    monkeypatch.setattr(cuda_build, "launch", _emulated_launch)
    problems = _problems(1, 7)
    for p in problems:
        got = term.terminate_fused(*p, EPS_T, EPS_R)
        assert got[0].R.shape == (3, 3) and got[1].shape == (3,) and got[2].shape == (4,)
        assert _equal(got, _plain(p))
    before = cuda_build.launches["icp_terminate"]
    P, A, PR, N = (_stack([p[i] for p in problems]) for i in range(4))
    out = vmap(lambda p, a, pr, n: term.terminate_fused(p, a, pr, n, EPS_T, EPS_R))(P, A, PR, N)
    assert cuda_build.launches["icp_terminate"] == before + 1
    assert out[1].shape == (7, 3) and out[1].dtype == torch.bool
    for b, p in enumerate(problems):
        assert _equal((Pose(out[0].R[b], out[0].t[b]), out[1][b], out[2][b]), _plain(p))


def test_vmap_rule_shares_unbatched_inputs(monkeypatch):
    """One set of pairings and one pose, the solver's poses batched: the
    shared inputs go to the kernel once with stride 0, and each problem is
    the single test."""
    calls = []

    def launch(kernel, dev, B, args, *rest):
        calls.append([None if a is None else a[1] for a in args])
        _emulated_launch(kernel, dev, B, args, *rest)

    monkeypatch.setattr(cuda_build, "launch", launch)
    pairings, pose, prev, _ = _problems(2, 1)[0]
    news = [se3.compose(pose, se3.from_xyz_ypr(4e-4 * b, 0, 0, 0, 0, 6e-5 * b))
            for b in range(4)]
    out = vmap(lambda n: term.terminate_fused(pairings, pose, prev, n, EPS_T, EPS_R))(
        _stack(news))
    assert calls == [[False] * 4 + [True, True, False, None, False, None, None]]
    for b, n in enumerate(news):
        assert _equal((Pose(out[0].R[b], out[0].t[b]), out[1][b], out[2][b]),
                      _plain((pairings, pose, prev, n)))
    assert out[1][:, 2].tolist() == [True, True, False, False]  # the small steps stall


def _scene_pair(seed, n=512, device="cpu"):
    """(local, global) layers: a scan of n points around a point of one
    scene (drawn from ``seed``), moved by a small pose, and the scene."""
    scene = np.random.RandomState(0).uniform(-30, 30, (4096, 3)).astype(np.float32)
    center = scene[np.random.RandomState(seed).randint(len(scene))]
    pts = scene[np.linalg.norm(scene - center, axis=1) < 25.0][:n]
    gt = se3.from_xyz_ypr(0.3, -0.2, 0.1, 0.04, -0.02, 0.01, device="cpu")
    loc = se3.apply(se3.inverse(gt), torch.from_numpy(pts)).numpy()
    return ({"raw": PointCloud.from_numpy(loc, capacity=n, device=device)},
            {"raw": PointCloud.from_numpy(scene, capacity=4096, device=device)})


def _icp():
    return ICP(matchers=[MatcherPointsDistanceThreshold(threshold=2.0)],
               solvers=[SolverHorn(run_up_to_iteration=2),
                        SolverGaussNewton(run_from_iteration=3,
                                          gn_params=GNParams(max_iterations=2))])


def test_icp_routes_every_test_to_the_kernel(monkeypatch):
    """With the rule forced (a CPU tensor otherwise never reaches the
    kernel) and the launch emulated: ICP.align and the batched align give
    the plain runs' poses, iterations and termination reasons to the bit,
    with one launch an ICP iteration (one for the whole batch)."""
    icp, params = _icp(), ICPParameters(max_iterations=12)
    local, glob = _scene_pair(3)
    guess = se3.identity()
    plain = icp.align(local, glob, guess, params)
    batch_run = make_batched_align(icp, params, broadcast_globals=True)
    locals_ = stack_pytrees([local, _scene_pair(4)[0]])
    guesses = stack_pytrees([guess, guess])
    plain_b = batch_run(locals_, glob, guesses)

    monkeypatch.setattr(cuda_build, "launch", _emulated_launch)
    monkeypatch.setattr(term, "takes_kernel", lambda *args: True)
    before = cuda_build.launches["icp_terminate"]
    got = icp.align(local, glob, guess, params)
    assert cuda_build.launches["icp_terminate"] == before + got.n_iterations
    assert got.n_iterations == plain.n_iterations > 3
    assert got.termination_reason == plain.termination_reason
    assert torch.equal(got.optimal_tf.R, plain.optimal_tf.R)
    assert torch.equal(got.optimal_tf.t, plain.optimal_tf.t)
    before = cuda_build.launches["icp_terminate"]
    got_b = batch_run(locals_, glob, guesses)
    assert cuda_build.launches["icp_terminate"] == before + int(got_b.n_iterations.max())
    for name in ("n_iterations", "termination_reason"):
        assert torch.equal(getattr(got_b, name), getattr(plain_b, name))
    assert torch.equal(got_b.optimal_tf.R, plain_b.optimal_tf.R)
    assert torch.equal(got_b.optimal_tf.t, plain_b.optimal_tf.t)


def test_wrapper_raises_without_a_card():
    pairings, pose, prev, new = _problems(5, 1)[0]
    with pytest.raises(ValueError, match="runs on the card"):
        term.terminate_fused(pairings, pose, prev, new, EPS_T, EPS_R)


# -------------------------------------------------------------- on the card
N_TRIPLES = 100_000


def _many(seed, n, rows=16):
    """n problems on the CPU, stacked: pairings with live pt2pl and pl2pl
    blocks (every 9th problem with no valid row, every 13th with only NaN,
    negative and zero weights), and ``_triples`` of each kind in turn;
    every 11th a rotation by pi from the identity (the near-pi branch at
    its limit)."""
    rng = np.random.RandomState(seed)
    pose, prev, new = _triples(rng, [KINDS[b % len(KINDS)] for b in range(n)])
    flip = np.arange(n) % 11 == 10
    axis = rng.randn(int(flip.sum()), 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    for p in (pose, prev):
        p.R[flip], p.t[flip] = torch.eye(3), 0.0
    new.R[flip] = torch.as_tensor(2.0 * axis[:, :, None] * axis[:, None, :] - np.eye(3),
                                  dtype=torch.float32)
    new.t[flip] = torch.as_tensor(rng.randn(len(axis), 3), dtype=torch.float32)
    pt2pl = torch.as_tensor(np.where(rng.rand(n, rows) < 0.5, rng.uniform(0.1, 2, (n, rows)),
                                     0.0), dtype=torch.float32)
    pt2pl[::9] = 0.0
    pt2pl[::13] = torch.as_tensor(rng.choice([math.nan, -1.0, 0.0], (len(pt2pl[::13]), rows)),
                                  dtype=torch.float32)
    empty = Pairings.empty(pt2pl_cap=rows, device="cpu")
    P = pytree.tree_map(lambda x: x.expand(n, *x.shape), dataclasses.replace(
        empty, live=frozenset({"pt2pl", "pl2pl"})))
    P = dataclasses.replace(P, pt2pl=dataclasses.replace(P.pt2pl, weight=pt2pl),
                            pl2pl=dataclasses.replace(P.pl2pl, weight=torch.zeros(n, 8)))
    return P, (pose, prev, new)


def _to(x, dev):
    return pytree.tree_map(lambda v: v.to(dev), x)


def _fused_batch(P, poses, eps_t=EPS_T, eps_r=EPS_R):
    return vmap(lambda p, a, pr, n: term.terminate_fused(p, a, pr, n, eps_t, eps_r))(P, *poses)


def _plain_batch(P, poses, eps_t=EPS_T, eps_r=EPS_R):
    kept, flags = vmap(lambda p, a, pr, n: term.terminate_plain(p, a, pr, n, eps_t, eps_r))(
        P, *poses)
    a, prev, new = poses
    norms = torch.stack([*se3.delta_norms(a, new), *se3.delta_norms(prev, new)], dim=-1)
    return kept, flags, norms


@pytest.mark.cuda
def test_kernel_matches_the_plain_path_over_many_triples():
    """100,000 triples in one launch against the plain path on the card:
    the four step norms to the bit (NaN where NaN), every flag and the kept
    pose equal; then 300 of them as single launches against the plain path
    run for one problem, as the ICP loop runs it."""
    dev = _card()
    P, poses = _to(_many(40, N_TRIPLES), dev)
    got, want = _fused_batch(P, poses), _plain_batch(P, poses)
    (gp, gf, gn), (wp, wf, wn) = got, want
    for i, name in enumerate(("dt1", "dr1", "dt2", "dr2")):
        bad = ~((gn[:, i] == wn[:, i]) | (torch.isnan(gn[:, i]) & torch.isnan(wn[:, i])))
        assert int(bad.sum()) == 0, (name, int(bad.sum()), gn[bad][:4], wn[bad][:4])
    assert torch.equal(gf, wf)
    assert torch.equal(gp.R, wp.R) and torch.equal(gp.t, wp.t)
    # the cases are there: no pairs, solver errors, stalls, the near-pi branch
    assert int(wf[:, 0].sum()) > N_TRIPLES // 12 and int((~wf[:, 1]).sum()) > N_TRIPLES // 10
    assert int(wf[:, 2].sum()) > N_TRIPLES // 5
    assert int((wn[:, 1] > 3.1).sum()) > N_TRIPLES // 20
    for b in range(0, N_TRIPLES, N_TRIPLES // 300):
        one = pytree.tree_map(lambda x: x[b], (P, *poses))
        assert _equal(term.terminate_fused(*one, EPS_T, EPS_R), _plain(one)), b


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["dt1", "dr1", "dt2", "dr2"])
def test_stall_flag_at_the_threshold(which):
    """The threshold at a step norm and 1 float32 ulp either side of it
    (the other threshold wide open): the stall flag as the plain path's,
    which stalls only below the norm."""
    dev = _card()
    P, poses = _to(_many(41, 100), dev)
    _, _, norms = _plain_batch(P, poses)
    i = ("dt1", "dr1", "dt2", "dr2").index(which)
    checked = 0
    for b in range(100):
        x = norms[b, i]
        if not torch.isfinite(x) or float(x) == 0.0:
            continue
        one = pytree.tree_map(lambda v: v[b], (P, *poses))
        for eps in (torch.nextafter(x, torch.zeros_like(x)), x,
                    torch.nextafter(x, torch.full_like(x, math.inf))):
            eps_t, eps_r = (float(eps), 10.0) if i % 2 == 0 else (1e6, float(eps))
            got = term.terminate_fused(*one, eps_t, eps_r)
            _, want_flags = term.terminate_plain(*one, eps_t, eps_r)
            assert torch.equal(got[1], want_flags), (b, float(eps))
        checked += 1
    assert checked > 45


@pytest.mark.cuda
def test_batch_equals_single_launches():
    """64 problems in one launch equal their 64 single launches bit for
    bit; one launch per test, one for the batch; a second batch repeats."""
    dev = _card()
    P, poses = _to(_many(42, 64, rows=600), dev)
    before = cuda_build.launches["icp_terminate"]
    singles = [term.terminate_fused(*pytree.tree_map(lambda x: x[b], (P, *poses)), EPS_T, EPS_R)
               for b in range(64)]
    runs = [_fused_batch(P, poses) for _ in range(2)]
    assert cuda_build.launches["icp_terminate"] == before + 66
    for kept, flags, norms in runs:
        for b, one in enumerate(singles):
            assert _equal((Pose(kept.R[b], kept.t[b]), flags[b], norms[b]), one), b


def _plain_run(monkeypatch, fn):
    """fn() with the rule sending every test to the plain path."""
    with monkeypatch.context() as m:
        m.setattr(term, "takes_kernel", lambda *args: False)
        return fn()


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True], ids=["align", "batched_align"])
def test_align_equals_the_plain_path_on_the_card(monkeypatch, batched):
    """ICP.align and the batched align through the kernel against the same
    runs on the plain path: poses, iterations and termination reasons equal
    to the bit, one launch an ICP iteration."""
    dev = _card()
    icp, params = _icp(), ICPParameters(max_iterations=20)
    pairs = [_scene_pair(s, n=2048, device=dev) for s in (5, 6, 7)]
    glob = pairs[0][1]
    if batched:
        run_fn = make_batched_align(icp, params, broadcast_globals=True)
        locals_ = stack_pytrees([p[0] for p in pairs])
        guesses = stack_pytrees([se3.identity(device=dev)] * 3)

        def run():
            res = run_fn(locals_, glob, guesses)
            return [(res.optimal_tf.R, res.optimal_tf.t, res.n_iterations,
                     res.termination_reason)], int(res.n_iterations.max())
    else:
        def run():
            out = [icp.align(p[0], glob, se3.identity(device=dev), params) for p in pairs]
            return ([(r.optimal_tf.R, r.optimal_tf.t, r.n_iterations, r.termination_reason)
                     for r in out], sum(r.n_iterations for r in out))
    want, _ = _plain_run(monkeypatch, run)
    before = cuda_build.launches["icp_terminate"]
    got, loops = run()
    assert cuda_build.launches["icp_terminate"] == before + loops
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
        if batched:
            assert torch.equal(g[2], w[2]) and torch.equal(g[3], w[3])
        else:
            assert g[2:] == w[2:]


@pytest.mark.cuda
def test_odometry_and_fleet_equal_the_plain_path_on_the_card(monkeypatch):
    """bench_torch.py's odometry configuration cut by 4: a run of one
    stream and the fleet of 2 through the kernel against the same runs on
    the plain path: poses, iterations, map counts and map rows equal, one
    launch an ICP iteration (a fleet iteration: one for both streams)."""
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

        def single():
            return mapper.run(frames[:6], twists=twists[:6], initial_pose=poses[0], dt=0.1)

        def fleet():
            return BatchedOdometryMapper(mapper).run(
                [frames[a:b] for a, b in cut], twists=[twists[a:b] for a, b in cut],
                initial_poses=poses, dt=0.1)

        for fn, key in ((single, "map"), (fleet, "maps")):
            want = _plain_run(monkeypatch, fn)
            before = cuda_build.launches["icp_terminate"]
            got = fn()
            iters = np.asarray(got["iterations"])
            loops = int(iters.sum()) if iters.ndim == 1 else int(iters.max(axis=0).sum())
            assert cuda_build.launches["icp_terminate"] == before + loops
            np.testing.assert_array_equal(got["poses"], want["poses"])
            np.testing.assert_array_equal(got["iterations"], want["iterations"])
            np.testing.assert_array_equal(got["map_counts"], want["map_counts"])
            assert torch.equal(got[key].xyz, want[key].xyz)
    finally:
        mp2p_icp_tpu_torch.set_default_device("cpu")
