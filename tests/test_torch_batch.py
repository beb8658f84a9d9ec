"""Batched registration in the port, held against the JAX package and
against the port's own sequential align on the CPU: the batched kNN front
end (the JAX package reaches its batched kernel through ``jax.vmap``), its
plain version, the sweep operator's vmap rule, and ``make_batched_align``
with a batched and a shared (broadcast) global map.

Tolerances: kNN results tie-tolerantly within the 2e-3 m² band of
``mp2p_icp_tpu_torch.parity``; the plain versions exactly; a batched
problem against the port's sequential align of the same problem within
1e-5 on R and t with identical iterations and termination (the same
arithmetic, only batched); against the JAX package's batched align within
5e-3 by error_log_norm, as the sequential aligns in test_torch_icp.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.icp import ICP as JICP
from mp2p_icp_tpu.icp import ICPParameters as JICPParameters
from mp2p_icp_tpu.matchers import MatcherPointsDistanceThreshold as JDistance
from mp2p_icp_tpu.ops import nn_bruteforce as jnb
from mp2p_icp_tpu.parallel.batch import make_batched_align as jmake_batched_align
from mp2p_icp_tpu.parallel.batch import stack_pytrees as jstack_pytrees
from mp2p_icp_tpu.solvers.gauss_newton import GNParams as JGNParams
from mp2p_icp_tpu.solvers.solver import SolverGaussNewton as JGN
from mp2p_icp_tpu.solvers.solver import SolverHorn as JHorn
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.params import Expression
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters, IterTermReason
from mp2p_icp_tpu_torch.matchers import MatcherPointsDistanceThreshold
from mp2p_icp_tpu_torch.ops import cuda_build
from mp2p_icp_tpu_torch.ops import nn_bruteforce as tnb
from mp2p_icp_tpu_torch.parallel import make_batched_align, stack_pytrees
from mp2p_icp_tpu_torch.parity import TIE_TOL, knn_mismatch
from mp2p_icp_tpu_torch.quality.paired_ratio import QualityPairedRatio
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


B, Q, C = 5, 64, 256


def _knn_problem(broadcast, seed=5):
    rng = np.random.RandomState(seed)
    qs = rng.uniform(-10, 10, (B, Q, 3)).astype(np.float32)
    ps = rng.uniform(-10, 10, (C, 3) if broadcast else (B, C, 3)).astype(np.float32)
    qv = rng.rand(B, Q) > 0.1
    pv = rng.rand(*ps.shape[:-1]) > 0.1
    return qs, qv, ps, pv


# ---------------------------------------------------------------- kNN
@pytest.mark.parametrize("broadcast", [False, True])
def test_batched_front_end_matches_jax_vmap(broadcast):
    """The K2 route of the JAX package: vmap of the Pallas sweep in
    interpret mode (tests/test_nn_bruteforce.py:180-218), k=2."""
    qs, qv, ps, pv = _knn_problem(broadcast)

    def one(q, v, p, w):
        return jnb.knn_bruteforce(q, v, p, w, k=2, backend="pallas", interpret=True)

    p_axis = None if broadcast else 0
    ref = jax.vmap(one, in_axes=(0, 0, p_axis, p_axis))(
        jnp.asarray(qs), jnp.asarray(qv), jnp.asarray(ps), jnp.asarray(pv))
    res = tnb.knn_bruteforce_batched(torch.from_numpy(qs), torch.from_numpy(qv),
                                     torch.from_numpy(ps), torch.from_numpy(pv), k=2)
    assert res.idx.shape == (B, Q, 2)
    for b in range(B):
        pb = ps if broadcast else ps[b]
        bad = knn_mismatch(qs[b], pb, res.idx[b].numpy(), res.valid[b].numpy(),
                           np.asarray(ref.idx[b]), np.asarray(ref.dist_sq[b]),
                           np.asarray(ref.valid[b]), tol=TIE_TOL)
        assert not bad.any(), f"problem {b}: {bad.sum()} entries disagree beyond ties"


@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_batched_front_end_equals_per_problem(broadcast, k):
    """Bit for bit equal to knn_bruteforce on each problem, with a
    per-problem radius ([B]) and a per-query one ([B, Q])."""
    qs, qv, ps, pv = _knn_problem(broadcast, seed=k)
    t = [torch.from_numpy(x) for x in (qs, qv, ps, pv)]
    rng = np.random.RandomState(k)
    for radius in (torch.from_numpy(rng.uniform(1, 30, B).astype(np.float32)),
                   torch.from_numpy(rng.uniform(1, 30, (B, Q)).astype(np.float32))):
        res = tnb.knn_bruteforce_batched(*t, k=k, max_radius_sq=radius)
        for b in range(B):
            pb, pvb = (t[2], t[3]) if broadcast else (t[2][b], t[3][b])
            one = tnb.knn_bruteforce(t[0][b], t[1][b], pb, pvb, k=k,
                                     max_radius_sq=radius[b])
            for a, e in zip(res, one):
                assert torch.equal(a[b], e)


@pytest.mark.parametrize("k", [1, 8])
def test_knn_plain_batched_equals_knn_plain(k):
    rng = np.random.RandomState(k)
    q = torch.from_numpy(rng.uniform(-5, 5, (3, 100, 3)).astype(np.float32))
    p = torch.from_numpy(rng.uniform(-5, 5, (3, 400, 3)).astype(np.float32))
    p[:, 200:210] = p[:, 190:191]  # exact ties
    for pb in (p, p[0]):
        d, i = tnb.knn_plain_batched(q, pb, k)
        for b in range(3):
            d_ref, i_ref = tnb.knn_plain(q[b], pb[b] if pb.ndim == 3 else pb, k)
            assert torch.equal(d[b], d_ref) and torch.equal(i[b], i_ref)
    d_cpu, i_cpu = tnb.knn_sweep_batched(q, p, k)
    d, i = tnb.knn_plain_batched(q, p, k)
    assert torch.equal(d_cpu, d) and torch.equal(i_cpu, i)


def test_vmap_of_front_end_takes_the_batched_sweep(monkeypatch):
    """torch.func.vmap of knn_bruteforce goes through the sweep operator's
    vmap rule: one batched sweep for all problems, same result as the
    batched front end."""
    qs, qv, ps, pv = _knn_problem(broadcast=True)
    calls = []
    real = tnb.knn_sweep_batched

    def spy(q, p, k, *counts):
        calls.append((tuple(q.shape), tuple(p.shape)))
        return real(q, p, k, *counts)

    monkeypatch.setattr(tnb, "knn_sweep_batched", spy)
    t = [torch.from_numpy(x) for x in (qs, qv, ps, pv)]
    res = torch.func.vmap(lambda q, v: tnb.knn_bruteforce(q, v, t[2], t[3], k=2))(t[0], t[1])
    assert calls == [((B, Q, 3), (C, 3))]
    ref = tnb.knn_bruteforce_batched(*t, k=2)
    for a, e in zip(res, ref):
        assert torch.equal(a, e)


def test_batched_sweep_checks_arguments():
    q = torch.zeros(2, 4, 3)
    with pytest.raises(ValueError):
        tnb.knn_sweep_batched(q[0], q[0], 1)  # nothing batched
    with pytest.raises(ValueError):
        tnb.knn_sweep_batched(q, torch.zeros(3, 4, 3), 1)  # batch sizes differ
    with pytest.raises(ValueError):
        tnb.knn_sweep_batched(q, q, 9)
    before = cuda_build.launches["knn_batched"]
    tnb.knn_sweep_batched(q, q, 1)
    assert cuda_build.launches["knn_batched"] == before  # CPU: no kernel


# -------------------------------------------------------------- align
def _align_problems(n_batch=3, seed=11):
    """tests/test_parallel.py:214-263: B scans cut from one 4096-point
    scene, each moved by its own ground truth."""
    rng = np.random.RandomState(seed)
    scene = rng.uniform(-40, 40, (4096, 3)).astype(np.float32)
    locals_, gts = [], []
    for b in range(n_batch):
        center = scene[rng.randint(0, scene.shape[0])]
        pts = scene[np.linalg.norm(scene - center, axis=1) < 25.0][:512]
        gt = se3.from_xyz_ypr(0.3 + 0.1 * b, -0.2, 0.1, 0.04, -0.02, 0.01)
        locals_.append(se3.apply(se3.inverse(gt), torch.from_numpy(pts)).numpy())
        gts.append(gt)
    return scene, locals_, gts


def _both_icps():
    jm = [JDistance(threshold=2.0)]
    js = [JHorn(run_up_to_iteration=2),
          JGN(run_from_iteration=3, gn_params=JGNParams(max_iterations=2))]
    ticp = convert.icp_from_config([convert.config_of(m) for m in jm],
                                   [convert.config_of(s) for s in js])
    return JICP(matchers=jm, solvers=js), ticp


@pytest.mark.parametrize("broadcast", [True, False])
def test_batched_align_matches_sequential_and_jax(broadcast):
    scene, locals_, gts = _align_problems()
    jicp, ticp = _both_icps()
    kw = dict(max_iterations=10, crop_capacity=2048, crop_extra_margin=2.0)
    gmap = {"raw": PointCloud.from_numpy(scene, capacity=4096)}
    l_t = [{"raw": PointCloud.from_numpy(x, capacity=512)} for x in locals_]
    fn = make_batched_align(ticp, ICPParameters(**kw), broadcast_globals=broadcast)
    res = fn(stack_pytrees(l_t), gmap if broadcast else stack_pytrees([gmap] * 3),
             stack_pytrees([se3.identity()] * 3))
    assert res.n_iterations.dtype == torch.int32 and res.n_iterations.shape == (3,)
    assert res.termination_reason.shape == (3,) and res.covariance.shape == (3, 6, 6)

    jgmap = {"raw": JPointCloud.from_numpy(scene, capacity=4096)}
    l_j = [{"raw": JPointCloud.from_numpy(x, capacity=512)} for x in locals_]
    jfn = jmake_batched_align(jicp, JICPParameters(**kw), broadcast_globals=broadcast)
    jres = convert.results_to_numpy(jfn(
        jstack_pytrees(l_j), jgmap if broadcast else jstack_pytrees([jgmap] * 3),
        jstack_pytrees([jse3.identity()] * 3)))
    tnp = convert.results_to_numpy(res)
    for b in range(3):
        seq = ticp.align(l_t[b], gmap, se3.identity(), ICPParameters(**kw))
        np.testing.assert_allclose(res.optimal_tf.R[b].numpy(), seq.optimal_tf.R.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(res.optimal_tf.t[b].numpy(), seq.optimal_tf.t.numpy(),
                                   atol=1e-5)
        assert int(res.n_iterations[b]) == seq.n_iterations
        assert int(res.termination_reason[b]) == seq.termination_reason
        assert torch.equal(res.final_pairings.pt2pt.global_idx[b],
                           seq.final_pairings.pt2pt.global_idx)
        assert float(res.quality[b]) == pytest.approx(float(seq.quality), abs=1e-6)
        pj = convert.pose_from_numpy(jres["R"][b], jres["t"][b])
        assert float(se3.error_log_norm(pj, se3.Pose(res.optimal_tf.R[b],
                                                     res.optimal_tf.t[b]))) < 5e-3
        assert tnp["termination_reason"][b] == jres["termination_reason"][b]
        assert abs(int(tnp["n_iterations"][b]) - int(jres["n_iterations"][b])) <= 1
        assert float(se3.error_log_norm(gts[b], seq.optimal_tf)) < 0.05


def test_stopped_problem_stays_frozen():
    """A problem that finds no pairings stops after one iteration and keeps
    its guess, pairings and count while the other problems run on."""
    scene, locals_, _ = _align_problems()
    locals_[1] = locals_[1] + 1000.0  # far from the map: no pairings
    icp = ICP(matchers=[MatcherPointsDistanceThreshold(threshold=2.0)],
              solvers=[SolverHorn()])
    params = ICPParameters(max_iterations=10)
    gmap = {"raw": PointCloud.from_numpy(scene, capacity=4096)}
    l_t = [{"raw": PointCloud.from_numpy(x, capacity=512)} for x in locals_]
    guesses = [se3.from_xyz_ypr(0.1 * b, 0.0, 0.0, 0.0, 0.0, 0.0) for b in range(3)]
    res = make_batched_align(icp, params, broadcast_globals=True)(
        stack_pytrees(l_t), gmap, stack_pytrees(guesses))
    assert int(res.termination_reason[1]) == IterTermReason.NO_PAIRINGS
    assert int(res.n_iterations[1]) == 1
    assert torch.equal(res.optimal_tf.t[1], guesses[1].t)
    assert (res.final_pairings.pt2pt.weight[1] == 0).all()
    assert float(res.quality[1]) == 0.0
    for b in (0, 2):
        assert int(res.n_iterations[b]) > 1
        assert int(res.termination_reason[b]) == IterTermReason.STALLED
        seq = icp.align(l_t[b], gmap, guesses[b], params)
        np.testing.assert_allclose(res.optimal_tf.t[b].numpy(), seq.optimal_tf.t.numpy(),
                                   atol=1e-5)
        assert int(res.n_iterations[b]) == seq.n_iterations


@pytest.mark.parametrize("what", ["latch", "own_matcher_quality", "record_iterations",
                                  "expression", "hook"])
def test_unsupported_batched_options_raise(what):
    """The options that the batched align refused before they were ported
    run now, and every problem of the batch equals its sequential align
    (R, t within 1e-5, the same iterations, termination and quality):

    - the run_until latch, decided on the device per problem;
    - a quality evaluator with its own matcher whose threshold is an
      ICP_ITERATION expression: the batched final quality is evaluated at
      each problem's own final iteration (the problems end at different
      iterations, and the quality at iteration 0 differs for at least one);
    - the per-iteration records, row for row;
    - an Expression threshold of the ICP's matcher (the shared iteration);
    - a hook that stops a problem once its |t| exceeds 0.3 m."""
    scene, locals_, _ = _align_problems()
    matchers = [MatcherPointsDistanceThreshold(threshold=2.0)]
    solvers = [SolverHorn()]
    quality = (QualityPairedRatio(),)
    kw = dict(max_iterations=10)
    if what == "latch":
        solvers = [SolverHorn(run_until_translation_correction_smaller_than=0.05),
                   SolverGaussNewton(gn_params=GNParams(max_iterations=2))]
    elif what == "own_matcher_quality":
        quality = (QualityPairedRatio(reuse_icp_pairings=False, matcher=MatcherPointsDistanceThreshold(
            threshold=Expression("2.0 - 0.15*ICP_ITERATION"))),)
    elif what == "record_iterations":
        kw.update(record_iterations=True, record_pairings=True, record_pairings_capacity=64)
    elif what == "expression":
        matchers = [MatcherPointsDistanceThreshold(threshold=Expression("2.0 - 0.1*ICP_ITERATION"))]
    else:
        kw.update(iteration_hook=lambda it, R, t, n: torch.linalg.vector_norm(t) > 0.3)
    icp = ICP(matchers=matchers, solvers=solvers, quality_evaluators=quality)
    params = ICPParameters(**kw)
    gmap = {"raw": PointCloud.from_numpy(scene, capacity=4096)}
    l_t = [{"raw": PointCloud.from_numpy(x, capacity=512)} for x in locals_]
    guesses = [se3.from_xyz_ypr(-0.6 * b, 0.3 * b, 0.0, 0.1 * b, 0.0, 0.0) for b in range(3)]
    res = make_batched_align(icp, params, broadcast_globals=True)(
        stack_pytrees(l_t), gmap, stack_pytrees(guesses))
    quality_at_0 = []
    for b in range(3):
        seq = icp.align(l_t[b], gmap, guesses[b], params)
        np.testing.assert_allclose(res.optimal_tf.R[b].numpy(), seq.optimal_tf.R.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(res.optimal_tf.t[b].numpy(), seq.optimal_tf.t.numpy(),
                                   atol=1e-5)
        assert int(res.n_iterations[b]) == seq.n_iterations
        assert int(res.termination_reason[b]) == seq.termination_reason
        assert float(res.quality[b]) == pytest.approx(float(seq.quality), abs=1e-6)
        quality_at_0.append(float(icp._quality_stack(
            seq.final_pairings, gmap, l_t[b], seq.optimal_tf, 0)))
        if what == "record_iterations":
            assert res.iteration_poses.t.shape == (3, 10, 3)
            np.testing.assert_allclose(res.iteration_poses.t[b].numpy(),
                                       seq.iteration_poses.t.numpy(), atol=1e-5)
            assert torch.equal(res.iteration_pair_counts[b], seq.iteration_pair_counts)
            assert torch.equal(res.iteration_pairings.pt2pt.global_idx[b],
                               seq.iteration_pairings.pt2pt.global_idx)
    if what == "own_matcher_quality":
        assert len(set(res.n_iterations.tolist())) > 1
        assert any(abs(q0 - float(q)) > 1e-3 for q0, q in zip(quality_at_0, res.quality))
    if what == "hook":
        assert (res.termination_reason == IterTermReason.HOOK_REQUEST).any()


def test_convert_round_trips_stacked_clouds():
    rng = np.random.RandomState(3)
    clouds = [JPointCloud.from_numpy(rng.rand(n, 3).astype(np.float32), capacity=256,
                                     intensity=rng.rand(n).astype(np.float32))
              for n in (100, 256, 7)]
    stacked = jstack_pytrees(clouds)
    t = convert.pointcloud_from_jax(stacked)
    assert t.xyz.shape == (3, 256, 3) and t.count.tolist() == [100, 256, 7]
    assert t.capacity == 256
    back = convert.pointcloud_to_numpy(t)
    assert set(back) == {"xyz", "count", "intensity"}
    for name, v in back.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(stacked, name)))
    rebuilt = JPointCloud(**{k: jnp.asarray(v) for k, v in back.items()})
    np.testing.assert_array_equal(np.asarray(rebuilt.xyz), np.asarray(stacked.xyz))


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
@pytest.mark.parametrize("broadcast", [False, True])
def test_batched_kernel_matches_plain_on_card(broadcast):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the batched kNN kernel has no CPU mode")
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.uniform(-60, 60, (4, 777, 3)).astype(np.float32)).cuda()
    shape = (3001, 3) if broadcast else (4, 3001, 3)
    p = torch.from_numpy(rng.uniform(-60, 60, shape).astype(np.float32)).cuda()
    before = cuda_build.launches["knn_batched"]
    d, i = tnb.knn_sweep_batched(q, p, 4)
    d_ref, i_ref = tnb.knn_plain_batched(q, p, 4)
    torch.cuda.synchronize()
    assert cuda_build.launches["knn_batched"] == before + 1
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
