"""Parity of the port's DistanceThreshold and Adaptive matchers with the
JAX package on the CPU: the same street-scene layers (bench.make_scene /
sample_scan, 2048 points) and the same pose go through both.

Pair weights, local indices, global indices and global points must be
equal row for row, except on tie rows: rows whose neighbours' true d²
differ by less than 2e-3 m², or sit within 2e-3 m² of the threshold — the
band of the JAX package's own kNN rounding at street scale. At most 1% of
the rows may be such ties. The adaptive threshold must match the
reference's histogram formula to 1e-4 m² on the same kNN result; end to
end, the port's exact distances may move it within the 2e-3 m² band.

MatcherPoint2Plane, both branches (stored normals; kNN re-fit): weights and
local indices equal row for row and the planes (centroid, normal) to 1e-4,
except on at most 1% of the rows, where a kNN near-tie gave another
neighbour or the fit sits at the planarity threshold.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.pairings import Pairings as JPairings
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.matchers import MatchContext as JMatchContext
from mp2p_icp_tpu.matchers import MatcherAdaptive as JAdaptive
from mp2p_icp_tpu.matchers import MatcherPointsDistanceThreshold as JDistance
from mp2p_icp_tpu.matchers import MatchState as JMatchState
from mp2p_icp_tpu.matchers.point2plane import MatcherPoint2Plane as JPoint2Plane
from mp2p_icp_tpu.ops.normals import estimate_point_normals as jnormals
from mp2p_icp_tpu.ops.nn_bruteforce import knn_bruteforce as jknn
from mp2p_icp_tpu.quality.paired_ratio import QualityPairedRatio as JQuality
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pairings import Pairings
from mp2p_icp_tpu_torch.matchers import (
    MatchContext,
    MatcherAdaptive,
    MatcherPoint2Plane,
    MatcherPointsDistanceThreshold,
    MatchState,
)
from mp2p_icp_tpu_torch.matchers.adaptive import adaptive_threshold_sq
from mp2p_icp_tpu_torch.ops.nn_bruteforce import NNResult, knn_bruteforce
from mp2p_icp_tpu_torch.parity import TIE_TOL, true_dist_sq


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


N = 2048


@pytest.fixture(scope="module")
def layers():
    scene = bench.make_scene(np.random.RandomState(0))
    g = bench.sample_scan(scene, np.random.RandomState(1), n=N)
    loc = bench.sample_scan(scene, np.random.RandomState(2), n=N)
    gj, lj = {"raw": JPointCloud.from_numpy(g)}, {"raw": JPointCloud.from_numpy(loc)}
    gt = {"raw": convert.pointcloud_from_numpy(np.asarray(gj["raw"].xyz), N)}
    lt = {"raw": convert.pointcloud_from_numpy(np.asarray(lj["raw"].xyz), N)}
    return gj, lj, gt, lt


def _poses(xyz_ypr):
    pj = jse3.from_xyz_ypr(*xyz_ypr)
    return pj, convert.pose_from_numpy(np.asarray(pj.R), np.asarray(pj.t))


def _to_port(jm):
    name, cfg = convert.config_of(jm)
    return convert.matcher_from_config(name, cfg)


def assert_blocks_match(bj, bt, local_pts, global_pts, thr_sq):
    """Row-for-row equality of two pt2pt blocks except explained tie rows."""
    wj, wt = np.asarray(bj.weight), bt.weight.numpy()
    gj, gt = np.asarray(bj.global_idx), bt.global_idx.numpy()
    np.testing.assert_array_equal(np.asarray(bj.local), bt.local.numpy())
    same = (wj == wt) & (gj == gt) & (np.asarray(bj.local_idx) == bt.local_idx.numpy())
    rows = np.nonzero(~same)[0]
    q = local_pts[rows // (len(wj) // len(local_pts))]
    dj = true_dist_sq(q, global_pts, gj[rows, None])[:, 0]
    dt = true_dist_sq(q, global_pts, gt[rows, None])[:, 0]
    tie = np.abs(np.nan_to_num(dj, nan=np.inf) - np.nan_to_num(dt, nan=np.inf)) <= TIE_TOL
    at_thr = (np.abs(np.nan_to_num(dj, nan=np.inf) - thr_sq) <= TIE_TOL) | (
        np.abs(np.nan_to_num(dt, nan=np.inf) - thr_sq) <= TIE_TOL)
    assert (tie | at_thr).all(), f"unexplained rows {rows[~(tie | at_thr)]}"
    assert len(rows) <= 0.01 * max((wj > 0).sum(), 1)
    ok = same & (wj > 0)
    np.testing.assert_array_equal(np.asarray(bj.globl)[ok], bt.globl.numpy()[ok])


def _run(jm, tm, layers, xyz_ypr, iteration):
    gj, lj, gt, lt = layers
    pj, pt = _poses(xyz_ypr)
    outj = jm.match({}, gj, lj, pj, None, JMatchContext(icp_iteration=jnp.asarray(iteration)))
    outt = tm.match(gt, lt, pt, None, MatchContext(icp_iteration=iteration))
    assert int(outj[2]) == int(outt[2])  # potential pairings
    return outj, outt, pt


@pytest.mark.parametrize("xyz_ypr", [(0.0,) * 6, (0.3, 0.1, 0.0, 0.01, 0.0, 0.0)])
@pytest.mark.parametrize("angular_deg,max_local", [(0.0, 0), (0.5, 700)])
def test_distance_threshold_matches_jax(layers, xyz_ypr, angular_deg, max_local):
    jm = JDistance(threshold=2.0, threshold_angular_deg=angular_deg,
                   max_local_points_per_layer=max_local, run_up_to_iteration=5)
    tm = _to_port(jm)
    assert tm == MatcherPointsDistanceThreshold(
        threshold=2.0, threshold_angular_deg=angular_deg,
        max_local_points_per_layer=max_local, run_up_to_iteration=5)
    (bj, _, _), (bt, _, _), pt = _run(jm, tm, layers, xyz_ypr, 0)
    local = se3.apply(pt, layers[3]["raw"].xyz).numpy()[:N]
    # the threshold band only matters without the angular term (per-point
    # thresholds then differ by row; their ties show as d² ties too)
    assert_blocks_match(bj["pt2pt"], bt["pt2pt"], local,
                        layers[2]["raw"].xyz.numpy(), 4.0)
    assert int(bt["pt2pt"].count()) > 100


@pytest.mark.parametrize("xyz_ypr", [(1.1, 0.05, 0.01, 0.01, 0.002, 0.001),
                                     (0.05, 0.01, 0.0, 0.001, 0.0, 0.0)])
def test_adaptive_matches_jax(layers, xyz_ypr):
    jm = JAdaptive(confidence_interval=0.75, first_to_second_distance_max=1.2,
                   absolute_max_search_distance=2.0, run_from_iteration=6)
    tm = _to_port(jm)
    (bj, _, _), (bt, _, _), pt = _run(jm, tm, layers, xyz_ypr, 6)
    gj, lj, gt, lt = layers
    pts = se3.apply(pt, lt["raw"].xyz)
    res = knn_bruteforce(pts, lt["raw"].valid_mask(), gt["raw"].xyz,
                         gt["raw"].valid_mask(), k=1, max_radius_sq=4.0)
    thr = float(adaptive_threshold_sq(res, 0.75, 0.1))
    assert_blocks_match(bj["pt2pt"], bt["pt2pt"], pts.numpy()[:N],
                        gt["raw"].xyz.numpy(), thr)
    # pt2pl stays empty with plane detection off
    assert (bt["pt2pl"].weight == 0).all() and (np.asarray(bj["pt2pl"].weight) == 0).all()

    # the threshold: on the JAX kNN result itself, the port's function
    # gives the reference formula's value (matchers/adaptive.py:160-182)
    rj = jknn(jse3.apply(jse3.Pose(jnp.asarray(pt.R.numpy()), jnp.asarray(pt.t.numpy())),
                         lj["raw"].xyz),
              lj["raw"].valid_mask(), gj["raw"].xyz, gj["raw"].valid_mask(), k=1,
              max_radius_sq=4.0)
    ref = _reference_threshold(np.asarray(rj.dist_sq)[:, 0], np.asarray(rj.valid)[:, 0])
    on_jax = NNResult(*(torch.from_numpy(np.array(x)) for x in (rj.idx, rj.dist_sq, rj.valid)))
    assert abs(float(adaptive_threshold_sq(on_jax, 0.75, 0.1)) - ref) < 1e-4
    # end to end the port's exact distances move it by at most the JAX
    # kNN's rounding band (measured 2e-4 m² here)
    assert abs(thr - ref) < TIE_TOL
    # and the JAX matcher's kept / rejected pairs bracket it
    dj = np.asarray(rj.dist_sq)[:, 0]
    kept = np.asarray(bj["pt2pt"].weight) > 0
    assert dj[kept].max() < thr + TIE_TOL
    rejected = np.asarray(rj.valid)[:, 0] & ~kept
    assert not rejected.any() or dj[rejected].min() > thr - TIE_TOL


def _reference_threshold(d, ok, ci=0.75, min_corr=0.1, bins=50):
    """matchers/adaptive.py:160-182 in numpy (f32, as the JAX code runs)."""
    d = np.where(ok, d, 0.0).astype(np.float32)  # invalid rows are not binned
    d_min, d_max = d[ok].min(), d[ok].max()
    span = np.float32(max(d_max - d_min, 1e-12))
    b = np.clip(((d - d_min) / span * np.float32(bins)).astype(np.int64), 0, bins - 1)
    hist = np.bincount(b[ok], minlength=bins)[:bins].astype(np.float32)
    cdf = np.cumsum(hist) / max(hist.sum(), 1.0)
    idx = int(np.argmax(cdf >= (1.0 + ci) * 0.5))
    return max(np.float32(min_corr) ** 2, d_min + np.float32(idx + 1) / bins * span)


def test_adaptive_threshold_matches_reference_formula(layers):
    _, _, gt, lt = layers
    pt = _poses((0.2, 0.0, 0.0, 0.0, 0.0, 0.0))[1]
    res = knn_bruteforce(se3.apply(pt, lt["raw"].xyz), lt["raw"].valid_mask(),
                         gt["raw"].xyz, gt["raw"].valid_mask(), k=1, max_radius_sq=4.0)
    thr = float(adaptive_threshold_sq(res, 0.75, 0.1))
    ref = _reference_threshold(res.dist_sq.numpy()[:, 0], res.valid.numpy()[:, 0])
    assert abs(thr - ref) < 1e-6


def test_two_matchers_share_paired_masks(layers):
    """DistanceThreshold then Adaptive in one iteration: the paired masks
    and the second matcher's output match the JAX package."""
    jd = JDistance(threshold=0.3)
    ja = JAdaptive(confidence_interval=0.75, absolute_max_search_distance=2.0)
    td, ta = _to_port(jd), _to_port(ja)
    gj, lj, gt, lt = layers
    pj, pt = _poses((0.05, 0.01, 0.0, 0.001, 0.0, 0.0))
    ctx_j, ctx_t = JMatchContext(icp_iteration=jnp.asarray(3)), MatchContext(icp_iteration=3)
    sj, st = JMatchState.create(lj, gj), MatchState.create(lt, gt)
    bdj, sj, _ = jd.match({}, gj, lj, pj, sj, ctx_j)
    bdt, st, _ = td.match(gt, lt, pt, st, ctx_t)
    baj, sj, _ = ja.match({}, gj, lj, pj, sj, ctx_j)
    bat, st, _ = ta.match(gt, lt, pt, st, ctx_t)
    local = se3.apply(pt, lt["raw"].xyz).numpy()[:N]
    glob = gt["raw"].xyz.numpy()
    assert_blocks_match(bdj["pt2pt"], bdt["pt2pt"], local, glob, 0.09)
    for name in ("local_paired", "global_paired"):
        a, b = np.asarray(getattr(sj, name)["raw"]), getattr(st, name)["raw"].numpy()
        assert (a != b).sum() <= 0.01 * a.sum()
    # the adaptive threshold is not returned: rows may only differ as ties
    wj, wt = np.asarray(baj["pt2pt"].weight), bat["pt2pt"].weight.numpy()
    assert (wj != wt).sum() <= 0.01 * max((wj > 0).sum(), 1)
    assert (wt > 0).sum() > 0


def test_adaptive_plane_detection_raises():
    """The plane stage is ported (test_adaptive_planes_match_jax holds it
    against the JAX package): it sets the kNN's k; a JAX matcher's
    spatial axis name converts only with the mesh that holds the axis."""
    assert MatcherAdaptive(enable_detect_planes=True, plane_search_points=6)._knn() == 6
    assert MatcherAdaptive(max_pt2pt_correspondences=2)._knn() == 2
    with pytest.raises(ValueError, match="mesh"):
        _to_port(dataclasses.replace(JDistance(), spatial_axis="space"))


@pytest.mark.parametrize("reuse", [True, False])
def test_paired_ratio_quality_matches_jax(layers, reuse):
    """The quality evaluator, on given pairings or with its own
    distance-threshold matcher (allow_match_already_matched_global_points,
    as the reference configures it); quality to 0.01 (tie rows)."""
    gj, lj, gt, lt = layers
    xyz_ypr = (0.05, 0.01, 0.0, 0.001, 0.0, 0.0)
    jd = JDistance(threshold=1.0)
    (bj, _, potj), (bt, _, pott), pt = _run(jd, _to_port(jd), layers, xyz_ypr, 0)
    pairs_j = dataclasses.replace(JPairings.empty(1), pt2pt=bj["pt2pt"],
                                  potential_pairings=potj)
    pairs_t = dataclasses.replace(Pairings.empty(1), pt2pt=bt["pt2pt"],
                                  potential_pairings=pott)
    jq = JQuality(reuse_icp_pairings=reuse, absolute_minimum_pairing_ratio=0.5,
                  matcher=JDistance(threshold=0.3,
                                    allow_match_already_matched_global_points=True))
    tq = convert.quality_from_config(*convert.config_of(jq))
    rj = jq.evaluate(pairs_j, grids={}, global_map=gj, local_map=lj, pose=_poses(xyz_ypr)[0],
                     ctx=JMatchContext(icp_iteration=jnp.asarray(0)))
    rt = tq.evaluate(pairs_t, global_map=gt, local_map=lt, pose=pt,
                     ctx=MatchContext(icp_iteration=0))
    assert abs(float(rt.quality) - float(rj.quality)) <= 0.01
    assert bool(rt.hard_discard) == bool(rj.hard_discard)


@pytest.mark.parametrize("stored_normals", [True, False], ids=["stored_normals", "knn_refit"])
@pytest.mark.parametrize("xyz_ypr", [(0.0,) * 6, (0.3, 0.1, 0.0, 0.01, 0.0, 0.0)])
def test_point2plane_matches_jax(layers, xyz_ypr, stored_normals):
    gj, lj, gt, lt = layers
    if stored_normals:
        gj = {"raw": jnormals(gj["raw"], knn=8, max_radius=3.0)}
        gt = {"raw": convert.pointcloud_from_jax(gj["raw"])}  # the same normals in both
    jm = JPoint2Plane(distance_threshold=3.0, knn=7, use_point_normals=stored_normals)
    tm = _to_port(jm)
    assert tm == MatcherPoint2Plane(distance_threshold=3.0, knn=7,
                                    use_point_normals=stored_normals)
    assert tm.search_radius() == jm.search_radius() == 3.0
    assert tm.out_blocks(lt) == {"pt2pl": N}
    (bj, _, potj), (bt, _, pott), _ = _run(jm, tm, (gj, lj, gt, lt), xyz_ypr, 0)
    assert int(potj) == int(pott) == N
    bj, bt = bj["pt2pl"], bt["pt2pl"]
    np.testing.assert_array_equal(bt.local.numpy(), np.asarray(bj.local))
    wj, wt = np.asarray(bj.weight), bt.weight.numpy()
    same = (wj == wt) & (np.asarray(bj.local_idx) == bt.local_idx.numpy())
    both = same & (wj > 0)
    for name in ("plane_centroid", "plane_normal"):
        gap = np.abs(np.asarray(getattr(bj, name)) - getattr(bt, name).numpy()).max(axis=1)
        same &= ~both | (gap <= 1e-4)
    assert (wt > 0).sum() > 200
    assert (~same).sum() <= 0.01 * (wj > 0).sum(), ((~same).sum(), (wj > 0).sum())  # tie rows


def test_point2plane_state_and_refusals(layers):
    _, _, gt, lt = layers
    pt = _poses((0.0,) * 6)[1]
    tm = MatcherPoint2Plane(distance_threshold=1.5)
    blocks, state, _ = tm.match(gt, lt, pt, MatchState.create(lt, gt), MatchContext(icp_iteration=0))
    assert torch.equal(state.local_paired["raw"], blocks["pt2pl"].weight > 0)
    assert not state.global_paired["raw"].any()
    # already paired local points are skipped by the next matcher
    again, _, _ = tm.match(gt, lt, pt, state, MatchContext(icp_iteration=0))
    assert int(again["pt2pl"].count()) == 0
    with pytest.raises(ValueError, match="no normals channel"):
        MatcherPoint2Plane(use_point_normals=True).match(
            gt, lt, pt, None, MatchContext(icp_iteration=0))
    with pytest.raises(TypeError, match="spatial_axis"):  # a name, not the rank's axis
        MatcherPoint2Plane(spatial_axis="space").match(
            gt, lt, pt, None, MatchContext(icp_iteration=0))


def _rows_match(bj, bt, vec_fields=(), frac=0.01, atol=1e-4):
    """Weights and local indices equal row for row, and the given [C, 3]
    fields within atol (a direction up to its sign), except on at most
    ``frac`` of the kept rows (kNN near-ties and fits at a threshold)."""
    wj, wt = np.asarray(bj.weight), bt.weight.numpy()
    same = (wj == wt) & (np.asarray(bj.local_idx) == bt.local_idx.numpy())
    both = same & (wj > 0)
    for name in vec_fields:
        a, b = np.asarray(getattr(bj, name)), getattr(bt, name).numpy()
        gap = np.minimum(np.abs(a - b).max(axis=1), np.abs(a + b).max(axis=1))
        same &= ~both | (gap <= atol)
    assert (~same).sum() <= frac * max((wj > 0).sum(), 1), ((~same).sum(), (wj > 0).sum())
    return wt


@pytest.mark.parametrize("ratio,max_local", [(0.8, 0), (0.5, 700)])
@pytest.mark.parametrize("xyz_ypr", [(0.0,) * 6, (0.3, 0.1, 0.0, 0.01, 0.0, 0.0)])
def test_inlier_ratio_matches_jax(layers, ratio, max_local, xyz_ypr):
    """Unbounded 1-NN and the masked quantile: the kept set equals the JAX
    package's except ties at the cut (within the kNN's rounding band)."""
    from mp2p_icp_tpu.matchers import MatcherPointsInlierRatio as JInlier

    jm = JInlier(inliers_ratio=ratio, max_local_points_per_layer=max_local)
    tm = _to_port(jm)
    assert tm.search_radius() == jm.search_radius() == 2.0
    assert tm.out_blocks(layers[3]) == {"pt2pt": N}
    (bj, _, _), (bt, _, _), pt = _run(jm, tm, layers, xyz_ypr, 0)
    wj = np.asarray(bj["pt2pt"].weight)
    local = se3.apply(pt, layers[3]["raw"].xyz).numpy()[:N]
    glob = layers[2]["raw"].xyz.numpy()
    cut = true_dist_sq(local, glob, np.asarray(bj["pt2pt"].global_idx)[:, None])[wj > 0].max()
    assert_blocks_match(bj["pt2pt"], bt["pt2pt"], local, glob, cut)
    n_valid = (700 if max_local else N)
    assert abs(int((bt["pt2pt"].weight > 0).sum()) - np.ceil(ratio * n_valid)) <= 0.01 * N


@pytest.fixture(scope="module")
def planar_layers():
    """Two 361-ray planar scans of the street scene 0.3 m and 2° apart
    (layer "2d_lidar"), in both packages."""
    from mp2p_icp_tpu_torch.eval.lidar_sim import make_street_scene, render_planar_scan

    scene = make_street_scene(np.random.RandomState(0))
    g = render_planar_scan(scene, 45.0, 0.0, 0.0, np.random.RandomState(1), n_rays=361)
    loc = render_planar_scan(scene, 45.3, 0.05, np.deg2rad(2.0), np.random.RandomState(2),
                             n_rays=361)
    gj = {"2d_lidar": JPointCloud.from_numpy(g)}
    lj = {"2d_lidar": JPointCloud.from_numpy(loc)}
    return (gj, lj, {"2d_lidar": convert.pointcloud_from_jax(gj["2d_lidar"])},
            {"2d_lidar": convert.pointcloud_from_jax(lj["2d_lidar"])})


@pytest.mark.parametrize("knn", [4, 5])
@pytest.mark.parametrize("xyz_ypr", [(0.0,) * 6, (0.3, 0.05, 0.0, np.deg2rad(2.0), 0.0, 0.0)])
def test_point2line_matches_jax(planar_layers, knn, xyz_ypr):
    """K1 at k = knn within the distance threshold, a line fit per
    neighbourhood: weights and local indices row for row, the lines
    (point, direction up to sign) to 1e-4, except ties (<= 1%)."""
    from mp2p_icp_tpu.matchers.point2line import MatcherPoint2Line as JPoint2Line
    from mp2p_icp_tpu_torch.matchers import MatcherPoint2Line

    lm = {"global_layer": "2d_lidar", "local_layer": "2d_lidar"}
    from mp2p_icp_tpu.matchers import LayerMatch as JLayerMatch

    jm = JPoint2Line(distance_threshold=0.25, knn=knn, min_points_to_fit=4,
                     line_eigen_threshold=1e-2, layer_matches=(JLayerMatch(**lm),))
    tm = _to_port(jm)
    assert tm.search_radius() == 0.25
    (bj, sj, _), (bt, st, _), _ = _run(jm, tm, planar_layers, xyz_ypr, 0)
    wt = _rows_match(bj["pt2ln"], bt["pt2ln"], ("line_point", "line_dir"))
    assert (wt > 0).sum() > 30
    with pytest.raises(ValueError, match="knn=9"):
        MatcherPoint2Line(knn=9)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("xyz_ypr", [(0.0,) * 6, (0.3, 0.1, 0.0, 0.01, 0.0, 0.0)])
def test_adaptive_planes_match_jax(layers, xyz_ypr, with_state):
    """The plane stage: K1 at k = 8, a plane per neighbourhood, pt2pl pairs
    for plane-like ones near the moved point, pt2pt for the rest. Both
    blocks row for row except ties (<= 1%), planes to 1e-4; with a
    MatchState the paired and claimed masks too."""
    jm = JAdaptive(enable_detect_planes=True, plane_search_points=8, confidence_interval=0.75,
                   first_to_second_distance_max=1.2, absolute_max_search_distance=2.0)
    tm = _to_port(jm)
    gj, lj, gt, lt = layers
    pj, pt = _poses(xyz_ypr)
    sj = JMatchState.create(lj, gj) if with_state else None
    st = MatchState.create(lt, gt) if with_state else None
    bj, sj, potj = jm.match({}, gj, lj, pj, sj, JMatchContext(icp_iteration=jnp.asarray(6)))
    bt, st, pott = tm.match(gt, lt, pt, st, MatchContext(icp_iteration=6))
    assert int(potj) == int(pott)
    wpl = _rows_match(bj["pt2pl"], bt["pt2pl"], ("plane_centroid", "plane_normal"))
    assert (wpl > 0).sum() > 20
    wpt = _rows_match(bj["pt2pt"], bt["pt2pt"])
    assert (wpt > 0).sum() > 0 and not ((wpt > 0) & (wpl > 0)).any()
    if with_state:
        for name in ("local_paired", "global_paired"):
            a, b = np.asarray(getattr(sj, name)["raw"]), getattr(st, name)["raw"].numpy()
            assert (a != b).sum() <= 0.01 * max(a.sum(), 1)
