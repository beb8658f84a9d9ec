"""Scan-to-large-map localisation in the port, held against the JAX package
on the CPU: the streamed kNN front end (maps above ``stream_block`` points),
its plain version, the crop of large global layers at the guess
(``ICP._crop_globals``), a scan-to-map align through the crop, and the
translation of recorded pairings back to the user's map rows.

Tolerances: kNN results are compared tie-tolerantly within the 2e-3 m²
band of ``mp2p_icp_tpu_torch.parity`` (the JAX distances are
|p|² - 2q·p + |q|², the port's exact (q - p)²); the plain versions and the
crop must agree exactly; the align is held to the same termination,
iterations within 1 and poses within 5e-3 by error_log_norm, as the
scan-to-scan align in test_torch_icp.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.icp import ICP as JICP
from mp2p_icp_tpu.icp import ICPParameters as JICPParameters
from mp2p_icp_tpu.matchers import MatcherAdaptive as JAdaptive
from mp2p_icp_tpu.matchers import MatcherPointsDistanceThreshold as JDistance
from mp2p_icp_tpu.matchers.base import LayerMatch as JLayerMatch
from mp2p_icp_tpu.ops import nn_bruteforce as jnb
from mp2p_icp_tpu.solvers.gauss_newton import GNParams as JGNParams
from mp2p_icp_tpu.solvers.solver import SolverGaussNewton as JGN
from mp2p_icp_tpu.solvers.solver import SolverHorn as JHorn
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.icp import ICPParameters
from mp2p_icp_tpu_torch.ops import cuda_build
from mp2p_icp_tpu_torch.ops import nn_bruteforce as tnb
from mp2p_icp_tpu_torch.parity import TIE_TOL, knn_mismatch


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _corridor_scene(rng, n, length=400.0):
    """A long corridor: ground + two walls + boxes (copied from
    tests/test_largemap.py:84-105)."""
    t = rng.uniform(0, length, n)
    kind = rng.randint(0, 4, n)
    y = np.where(kind == 0, -6.0, np.where(kind == 1, 6.0,
                 rng.uniform(-6, 6, n)))
    z = np.where(kind < 2, rng.uniform(0, 4, n),
                 np.where(kind == 2, 0.02 * rng.randn(n),
                          rng.uniform(0, 2.5, n)))
    xq = np.where(kind == 3, np.round(t / 25.0) * 25.0 + 0.15 * rng.randn(n), t)
    return np.stack([xq, y, z], 1).astype(np.float32)


def _local_view(scene, center_x, rng, n=4096, radius=40.0, noise=0.01):
    m = np.abs(scene[:, 0] - center_x) < radius
    pts = scene[m]
    idx = rng.choice(pts.shape[0], size=min(n, pts.shape[0]), replace=False)
    return (pts[idx] + noise * rng.randn(idx.shape[0], 3)).astype(np.float32)


def _icp_pair(threshold=2.0, layer="raw"):
    """The scan-to-map ICP of bench.py:382-398 (DistanceThreshold + Horn
    for iterations 0-5, then Gauss-Newton with 3 inner steps), in both
    packages."""
    jm = [JDistance(threshold=threshold,
                    layer_matches=(JLayerMatch(global_layer=layer, local_layer="raw"),))]
    js = [JHorn(run_up_to_iteration=5),
          JGN(run_from_iteration=6, gn_params=JGNParams(max_iterations=3))]
    ticp = convert.icp_from_config([convert.config_of(m) for m in jm],
                                   [convert.config_of(s) for s in js])
    return JICP(matchers=jm, solvers=js), ticp


def _to_port(layers):
    return {k: convert.pointcloud_from_jax(v) for k, v in layers.items()}


def _pose(p):
    return convert.pose_from_numpy(np.asarray(p.R), np.asarray(p.t))


# ------------------------------------------------------- streamed front end
@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("k", [1, 3])
def test_streamed_front_end_matches_jax(backend, k):
    """Q=64 against C=1500 in superblocks of 512 (tests/test_largemap.py:55-68)."""
    rng = np.random.RandomState(4)
    Q, C = 64, 1500
    q = rng.uniform(-20, 20, (Q, 3)).astype(np.float32)
    p = rng.uniform(-20, 20, (C, 3)).astype(np.float32)
    qv = rng.rand(Q) > 0.1
    pv = rng.rand(C) > 0.1
    ref = jnb.knn_bruteforce(jnp.asarray(q), jnp.asarray(qv), jnp.asarray(p),
                             jnp.asarray(pv), k=k, backend=backend,
                             interpret=backend == "pallas", stream_block=512)
    res = tnb.knn_bruteforce(torch.from_numpy(q), torch.from_numpy(qv),
                             torch.from_numpy(p), torch.from_numpy(pv), k=k,
                             stream_block=512)
    bad = knn_mismatch(q, p, res.idx.numpy(), res.valid.numpy(), np.asarray(ref.idx),
                       np.asarray(ref.dist_sq), np.asarray(ref.valid), tol=TIE_TOL)
    assert not bad.any(), f"{bad.sum()} entries disagree beyond ties"
    # the streamed route gives the unstreamed result bit for bit
    whole = tnb.knn_bruteforce(torch.from_numpy(q), torch.from_numpy(qv),
                               torch.from_numpy(p), torch.from_numpy(pv), k=k)
    for a, b in zip(res, whole):
        assert torch.equal(a, b)


def test_front_end_routes_large_maps_to_streamed_sweep(monkeypatch):
    calls = []
    real = tnb.knn_sweep_streamed

    def spy(q, p, k, stream_block):
        calls.append((p.shape[0], stream_block))
        return real(q, p, k, stream_block)

    monkeypatch.setattr(tnb, "knn_sweep_streamed", spy)
    q, p = torch.zeros(8, 3), torch.ones(600, 3)
    ones = torch.ones(600, dtype=torch.bool)
    tnb.knn_bruteforce(q, ones[:8], p, ones, stream_block=600)
    assert calls == []
    tnb.knn_bruteforce(q, ones[:8], p, ones, stream_block=512)
    assert calls == [(600, 512)]


# ------------------------------------------------------------ plain versions
@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("stream_block", [7, 256, 1000])
def test_knn_plain_streamed_equals_knn_plain(k, stream_block):
    """Bit for bit, with exact duplicates on both sides of every
    superblock border, so the merge's tie-break (earlier superblock first)
    decides which index comes back."""
    rng = np.random.RandomState(k + stream_block)
    C = 1500
    p = rng.uniform(-5, 5, (C, 3)).astype(np.float32)
    for b in range(stream_block, C, stream_block):
        p[b - 2:b] = p[b]  # two copies before the border, one after
        p[b + 1] = p[b]
    q = np.concatenate([p[::37] + 0.0, rng.uniform(-5, 5, (50, 3)).astype(np.float32)])
    qt, pt = torch.from_numpy(q), torch.from_numpy(p)
    d_ref, i_ref = tnb.knn_plain(qt, pt, k)
    d, i = tnb.knn_plain_streamed(qt, pt, k, stream_block)
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
    d_cpu, i_cpu = tnb.knn_sweep_streamed(qt, pt, k, stream_block)
    assert torch.equal(d_cpu, d_ref) and torch.equal(i_cpu, i_ref)


def test_knn_plain_streamed_fewer_points_than_k():
    q, p = torch.zeros(3, 3), torch.ones(5, 3)
    d, i = tnb.knn_plain_streamed(q, p, 8, stream_block=2)
    d_ref, i_ref = tnb.knn_plain(q, p, 8)
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
    assert (i[:, 5:] == -1).all() and torch.isinf(d[:, 5:]).all()


@pytest.mark.parametrize("Q,C,n_sm", [(8192, 262144, 132), (777, 200_001, 132),
                                      (1, 300_000, 132), (8192, 1, 132), (64, 5000, 8)])
def test_stream_slices_cover_the_map(Q, C, n_sm):
    groups, S, slice_len = tnb.sweep_split(Q, C, n_sm)
    # a slice is whole groups of 4 points for each of a block's warps
    assert slice_len % (4 * groups) == 0 and slice_len >= 4 * groups
    assert S * slice_len >= C and (S - 1) * slice_len < max(C, 1)
    assert 1 <= S <= 65535


# ---------------------------------------------------------------------- crop
def _crop_problem(n_map, crop_capacity, n_local=1024, seed=7):
    rng = np.random.RandomState(seed)
    scene = _corridor_scene(rng, n_map)
    local = _local_view(scene, 200.0, rng, n=n_local, radius=30.0)
    channels = {"intensity": rng.rand(n_map).astype(np.float32),
                "ring": rng.randint(0, 64, n_map).astype(np.float32),
                "time": rng.rand(n_map).astype(np.float32)}
    g = JPointCloud.from_numpy(scene, capacity=n_map + 1000, **channels)
    nrm = np.zeros((n_map + 1000, 3), np.float32)
    nrm[:n_map] = rng.randn(n_map, 3)
    g = dataclasses.replace(g, normals=jnp.asarray(nrm))
    l_ = JPointCloud.from_numpy(local, capacity=n_local)
    guess = jse3.from_xyz_ypr(0.5, -0.3, 0.1, 0.02, 0.01, -0.01)
    return {"map": g}, {"raw": l_}, guess


@pytest.mark.parametrize("case", ["stride", "roomy", "off"])
def test_crop_matches_jax(case):
    """stride: the box holds more than crop_capacity points (decimated by
    an even stride); roomy: a crop larger than the in-box count; off:
    crop_to_local_bbox=False leaves the layer as it is."""
    g, l_, guess = _crop_problem(1 << 15, 1 << 12)
    M = {"stride": 1 << 12, "roomy": 1 << 14, "off": 1 << 12}[case]
    kw = dict(crop_capacity=M, crop_extra_margin=3.0,
              crop_to_local_bbox=False if case == "off" else None)
    jicp, ticp = _icp_pair(layer="map")
    jout, jmaps = jicp._crop_globals(JICPParameters(**kw), tuple(jicp.matchers), g, l_,
                                     guess)
    tg = _to_port(g)
    tout, tmaps = ticp._crop_globals(ICPParameters(**kw), tg, _to_port(l_), _pose(guess))
    if case == "off":
        assert jmaps == {} and tmaps == {} and tout["map"] is tg["map"]
        return
    jc, tc = jout["map"], tout["map"]
    count = int(tc.count)
    assert count == int(jc.count) and tc.capacity == jc.capacity == M
    if case == "stride":
        assert count > M // 2  # the stride kept a fair share of the box
    else:
        assert count < M  # every in-box point fits
    for name in ("xyz", "intensity", "ring", "time", "normals"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tmaps["map"].numpy(), np.asarray(jmaps["map"]))
    # kept rows are the user's rows, in map order
    rows = tmaps["map"].numpy()[:count]
    assert (np.diff(rows) > 0).all()
    np.testing.assert_array_equal(tc.xyz.numpy()[:count], np.asarray(g["map"].xyz)[rows])


@pytest.mark.parametrize("name", ["DistanceThreshold", "DistanceThresholdAngular", "Adaptive"])
def test_search_radius_matches_jax(name):
    jm = {"DistanceThreshold": JDistance(threshold=1.5),
          "DistanceThresholdAngular": JDistance(threshold=1.5, threshold_angular_deg=0.5),
          "Adaptive": JAdaptive(absolute_max_search_distance=3.0)}[name]
    tm = convert.matcher_from_config(*convert.config_of(jm))
    assert tm.search_radius() == pytest.approx(jm.search_radius(), rel=1e-6)


# ------------------------------------------------------------------- align
def _scan_to_map(n_map=1 << 14, n_scan=1024, seed=11):
    rng = np.random.RandomState(seed)
    scene = _corridor_scene(rng, n_map)
    scan = _local_view(scene, 200.0, np.random.RandomState(seed + 1), n=n_scan,
                       radius=35.0)
    sensor = se3.from_xyz_ypr(200.0, 0.0, 1.5, 0.0, 0.0, 0.0)
    gt = se3.compose(sensor, se3.from_xyz_ypr(0.8, 0.3, 0.05, 0.03, 0.005, -0.01))
    local = se3.apply(se3.inverse(gt), torch.from_numpy(scan)).numpy()
    return scene, local, sensor, gt


def test_scan_to_map_align_matches_jax():
    """A 1024-point sensor-frame scan against a 2^14-point corridor map,
    cropped to 2^12 points at the guess (bench.py:382-408, scaled down)."""
    scene, local, sensor, gt = _scan_to_map()
    jicp, ticp = _icp_pair(layer="map")
    kw = dict(max_iterations=40, crop_capacity=1 << 12, crop_extra_margin=4.0)
    jsensor = jse3.Pose(jnp.asarray(sensor.R.numpy()), jnp.asarray(sensor.t.numpy()))
    jres = jicp.align({"raw": JPointCloud.from_numpy(local, capacity=1024)},
                      {"map": JPointCloud.from_numpy(scene, capacity=1 << 14)},
                      jsensor, JICPParameters(**kw))
    tres = ticp.align({"raw": PointCloud.from_numpy(local, capacity=1024)},
                      {"map": PointCloud.from_numpy(scene, capacity=1 << 14)},
                      sensor, ICPParameters(**kw))
    assert tres.termination_reason == int(jres.termination_reason)
    assert abs(tres.n_iterations - int(jres.n_iterations)) <= 1
    pj = _pose(jres.optimal_tf)
    assert float(se3.error_log_norm(pj, tres.optimal_tf)) < 5e-3
    assert float(se3.error_log_norm(gt, tres.optimal_tf)) < 0.1
    assert float(se3.error_log_norm(gt, pj)) < 0.1


def test_recorded_global_idx_are_original_map_indices():
    """With the layer cropped, final_pairings.pt2pt.global_idx addresses the
    user's map rows (tests/test_largemap.py:203-233)."""
    rng = np.random.RandomState(7)
    scene = _corridor_scene(rng, 1 << 15)
    local_xyz = _local_view(scene, 200.0, rng, n=1024, radius=30.0)
    _, ticp = _icp_pair()
    res = ticp.align({"raw": PointCloud.from_numpy(local_xyz, capacity=1024)},
                     {"raw": PointCloud.from_numpy(scene, capacity=1 << 15)},
                     se3.identity(),
                     ICPParameters(max_iterations=25, crop_capacity=1 << 12,
                                   crop_extra_margin=4.0))
    gi = res.final_pairings.pt2pt.global_idx.numpy()
    sel = res.final_pairings.pt2pt.weight.numpy() > 0
    assert sel.sum() > 100
    assert gi[sel].min() >= 0 and gi[sel].max() < scene.shape[0]
    np.testing.assert_array_equal(scene[gi[sel]], res.final_pairings.pt2pt.globl.numpy()[sel])
    assert (gi[~sel] == -1).all()


# ------------------------------------------------------------------ the card
@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_streamed_kernel_matches_plain_on_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the streamed kNN kernel has no CPU mode")
    rng = np.random.RandomState(k)
    q = torch.from_numpy(rng.uniform(-60, 60, (777, 3)).astype(np.float32)).cuda()
    p = torch.from_numpy(rng.uniform(-60, 60, (200_003, 3)).astype(np.float32)).cuda()
    before = cuda_build.launches["knn_streamed"]
    d, i = tnb.knn_sweep_streamed(q, p, k)
    d_ref, i_ref = tnb.knn_plain_streamed(q, p, k)
    torch.cuda.synchronize()
    assert cuda_build.launches["knn_streamed"] == before + 1
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
