"""The metric map, the voxel occupancy map and the voxel and range-image
quality evaluators of the port, against the JAX package on the CPU
(mirrors tests/test_voxel_occupancy.py:24-110 and tests/test_quality.py).

Bands: voxel keys and validity exactly, occupancy 1e-6 (the segment sums
of log-odds may add in another order); range images exactly (a z-buffer
is a minimum: any order gives the same image); qualities 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.metric_map import Georeferencing as JGeoreferencing
from mp2p_icp_tpu.core.metric_map import LineSet as JLineSet
from mp2p_icp_tpu.core.metric_map import MetricMap as JMetricMap
from mp2p_icp_tpu.core.metric_map import VoxelGridLayer as JVoxelGridLayer
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.ops import voxel_occupancy as jvo
from mp2p_icp_tpu.quality import range_image as jri
from mp2p_icp_tpu.quality import voxels as jqv
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.metric_map import MetricMap, VoxelGridLayer
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.ops import voxel_occupancy as tvo
from mp2p_icp_tpu_torch.quality import range_image as tri
from mp2p_icp_tpu_torch.quality import voxels as tqv


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _pose(xyz_ypr):
    pj = jse3.from_xyz_ypr(*xyz_ypr)
    return pj, convert.pose_from_numpy(np.asarray(pj.R), np.asarray(pj.t))


def assert_grids_equal(vt, vj):
    np.testing.assert_array_equal(vt.keys.numpy(), np.asarray(vj.keys))
    np.testing.assert_array_equal(vt.valid.numpy(), np.asarray(vj.valid))
    np.testing.assert_allclose(vt.occupancy.numpy(), np.asarray(vj.occupancy), atol=1e-6)
    assert vt.resolution == vj.resolution


# ------------------------------------------------------------- metric map
def test_metric_map_round_trip():
    """A JAX MetricMap with a point layer, a voxel layer, lines, planes,
    metadata and georeferencing, through convert: the same contents; merge
    and copy behave as the JAX package's."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-5, 5, (300, 3)).astype(np.float32)
    vj = jvo.update_voxel_map(JVoxelGridLayer.empty(1024, 0.5), jnp.asarray(pts),
                              jnp.ones(300, bool), jnp.zeros(3), carve_free_space=False)
    lines = JLineSet(point=jnp.ones((4, 3)), direction=jnp.zeros((4, 3)).at[:, 0].set(1.0),
                     count=jnp.asarray(2, jnp.int32))
    mj = JMetricMap(layers={"raw": JPointCloud.from_numpy(pts, intensity=pts[:, 0]),
                            "voxelmap": vj}, lines=lines, id=4, label="keyframe",
                    georeferencing=JGeoreferencing(latitude=36.8, longitude=-2.4))
    mt = convert.metric_map_from_jax(mj)
    assert mt.contents_summary() == mj.contents_summary()
    assert mt.size() == mj.size() and not mt.empty()
    assert dataclasses.asdict(mt.georeferencing) == dataclasses.asdict(mj.georeferencing)
    assert_grids_equal(mt.layers["voxelmap"], vj)
    np.testing.assert_array_equal(mt.layers["raw"].intensity.numpy(),
                                  np.asarray(mj.layers["raw"].intensity))
    np.testing.assert_array_equal(mt.lines.direction.numpy(), np.asarray(lines.direction))
    assert int(mt.lines.valid_mask().sum()) == 2 and int(mt.planes.count) == 0
    assert MetricMap().empty() and MetricMap().contents_summary() == "empty"
    # merge_with, with a pose: channels survive, the voxel layer is kept
    other = rng.uniform(-5, 5, (100, 3)).astype(np.float32)
    pj, pt = _pose((1.0, 2.0, 0.0, 0.3, 0.0, 0.0))
    oj = JMetricMap(layers={"raw": JPointCloud.from_numpy(other)})
    mj.merge_with(oj, pj)
    mt.copy().merge_with(convert.metric_map_from_jax(oj), pt)  # a copy is independent
    assert mt.layers["raw"].capacity == 512 and int(mt.layers["raw"].count) == 300
    mt.merge_with(convert.metric_map_from_jax(oj), pt)
    np.testing.assert_allclose(mt.layers["raw"].xyz.numpy(), np.asarray(mj.layers["raw"].xyz),
                               atol=1e-5)
    np.testing.assert_array_equal(mt.layers["raw"].intensity.numpy(),
                                  np.asarray(mj.layers["raw"].intensity))
    with pytest.raises(NotImplementedError, match="non-point layer"):
        mt.merge_with(MetricMap(layers={"voxelmap": mt.layers["voxelmap"]}), pt)
    with pytest.raises(TypeError):
        mt.point_layer("voxelmap")


# ------------------------------------------------------------ voxel map
@pytest.mark.parametrize("carve,updates,capacity", [
    (False, 1, 4096), (True, 1, 65536), (True, 3, 65536), (True, 2, 2000),
])
def test_update_voxel_map_matches_jax(carve, updates, capacity):
    """Scans of 500 points from moving sensor origins into one grid:
    exact keys and validity, occupancy to 1e-6; 2000 cells overflow (the
    first cells in code order are kept, in both packages)."""
    rng = np.random.RandomState(updates + 10 * carve)
    vj = JVoxelGridLayer.empty(capacity, 0.25)
    vt = VoxelGridLayer.empty(capacity, 0.25)
    for u in range(updates):
        origin = np.array([0.3 * u, -0.2 * u, 1.5], np.float32)
        pts = (origin + rng.uniform(-8, 8, (500, 3))).astype(np.float32)
        valid = rng.rand(500) > 0.1
        vj = jvo.update_voxel_map(vj, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(origin),
                                  ray_samples=16, carve_free_space=carve)
        vt = tvo.update_voxel_map(vt, torch.from_numpy(pts), torch.from_numpy(valid),
                                  torch.from_numpy(origin), ray_samples=16,
                                  carve_free_space=carve)
        assert_grids_equal(vt, vj)
    assert int(vt.valid.sum()) > 100
    q = rng.uniform(-9, 9, (700, 3)).astype(np.float32)
    np.testing.assert_allclose(tvo.lookup_occupancy(vt, torch.from_numpy(q)).numpy(),
                               np.asarray(jvo.lookup_occupancy(vj, jnp.asarray(q))), atol=1e-6)


def test_hits_become_occupied():
    vg = tvo.update_voxel_map(VoxelGridLayer.empty(256, resolution=0.5),
                              torch.tensor([[2.1, 0.1, 0.1]] * 5), torch.ones(5, dtype=torch.bool),
                              torch.zeros(3), carve_free_space=False)
    assert float(tvo.lookup_occupancy(vg, torch.tensor([[2.1, 0.1, 0.1]]))[0]) > 0.9


def test_free_space_carved():
    vg = VoxelGridLayer.empty(1024, resolution=0.5)
    pts = torch.tensor([[4.0, 0.1, 0.1]] * 10)
    for _ in range(3):
        vg = tvo.update_voxel_map(vg, pts, torch.ones(10, dtype=torch.bool), torch.zeros(3))
    assert float(tvo.lookup_occupancy(vg, torch.tensor([[2.0, 0.1, 0.1]]))[0]) < 0.3
    assert float(tvo.lookup_occupancy(vg, torch.tensor([[4.0, 0.1, 0.1]]))[0]) > 0.8


def test_unknown_is_default():
    vg = VoxelGridLayer.empty(64, resolution=0.5)
    assert float(tvo.lookup_occupancy(vg, torch.tensor([[9.0, 9.0, 9.0]]))[0]) == 0.5
    assert float(tvo.lookup_occupancy(vg, torch.tensor([[9.0, 9.0, 9.0]]), default=0.1)[0]) \
        == pytest.approx(0.1)


# ----------------------------------------------------------- QualityVoxels
def _grid_pair(rng, n, offset=0.0):
    pts = rng.uniform(2, 6, (n, 3)).astype(np.float32)
    grids = []
    for p in (pts, pts + offset):
        vj = jvo.update_voxel_map(JVoxelGridLayer.empty(8192, 0.5), jnp.asarray(p),
                                  jnp.ones(n, bool), jnp.zeros(3))
        grids.append((vj, convert.voxel_grid_from_jax(vj)))
    return grids


@pytest.mark.parametrize("offset,xyz_ypr", [
    (0.0, (0.0,) * 6), (0.0, (0.2, -0.1, 0.05, 0.05, 0.0, 0.01)), (3.0, (0.0,) * 6),
])
def test_quality_voxels_matches_jax(offset, xyz_ypr):
    """Two carved grids at a pose, both passes; agreeing maps score higher
    than disagreeing ones (tests/test_quality.py:128-148)."""
    (aj, at), (bj, bt) = _grid_pair(np.random.RandomState(2), 300, offset)
    pj, pt = _pose(xyz_ypr)
    qj = float(jqv.QualityVoxels().evaluate(None, global_map={"voxelmap": bj},
                                            local_map={"voxelmap": aj}, pose=pj).quality)
    qt = float(tqv.QualityVoxels().evaluate(None, global_map={"voxelmap": bt},
                                            local_map={"voxelmap": at}, pose=pt).quality)
    assert qt == pytest.approx(qj, abs=1e-5)
    assert 0.0 < qt < 1.0


def test_agreeing_maps_score_higher():
    (_, at), (_, bt) = _grid_pair(np.random.RandomState(2), 200)
    (_, ct), _ = _grid_pair(np.random.RandomState(3), 200, offset=0.0)
    q = tqv.QualityVoxels()
    assert float(q.evaluate_voxels(at, bt, se3.identity()).quality) > float(
        q.evaluate_voxels(at, VoxelGridLayer(ct.keys - 20, ct.occupancy, ct.valid, 0.5),
                          se3.identity()).quality)


def test_far_from_origin_cells_exact():
    """Cells at ±4000 (2 km at 0.5 m) are all found, with the occupancy of
    their own record; a disjoint query set finds nothing (the JAX test of
    the same name)."""
    rng = np.random.RandomState(0)
    keys = np.unique(rng.randint(-4000, 4000, (5000, 3)).astype(np.int32), axis=0)
    n = keys.shape[0]
    occ = rng.rand(n).astype(np.float32)
    vt = VoxelGridLayer(torch.from_numpy(keys), torch.from_numpy(occ),
                        torch.ones(n, dtype=torch.bool), 0.5)
    got, found = tqv.lookup_occupancy(vt, torch.from_numpy(keys), torch.ones(n, dtype=torch.bool))
    assert int(found.sum()) == n
    np.testing.assert_array_equal(got.numpy(), occ)
    _, found2 = tqv.lookup_occupancy(vt, torch.from_numpy(keys + 9001),
                                     torch.ones(n, dtype=torch.bool))
    assert int(found2.sum()) == 0
    # the codes are the JAX package's, bit for bit
    np.testing.assert_array_equal(tqv._hash(torch.from_numpy(keys)).numpy(),
                                  np.asarray(jqv._pack(jnp.asarray(keys))))


def test_quality_voxels_raises_on_missing_layers():
    vt = VoxelGridLayer.empty(16, 0.5)
    q = tqv.QualityVoxels()
    with pytest.raises(ValueError, match="no layer 'voxelmap'"):
        q.evaluate(None, global_map={}, local_map={"voxelmap": vt}, pose=se3.identity())
    with pytest.raises(ValueError, match="must be a voxel grid"):
        q.evaluate(None, global_map={"voxelmap": PointCloud.from_numpy(np.zeros((4, 3)))},
                   local_map={"voxelmap": vt}, pose=se3.identity())


# ------------------------------------------------------------- range image
def room_cloud(rng, n=2000):
    """Points on walls in front of the origin (tests/test_quality.py)."""
    walls = [np.stack([np.full(n // 2, x), rng.uniform(-3, 3, n // 2),
                       rng.uniform(-1, 2, n // 2)], 1) for x in (4.0, 8.0)]
    return np.concatenate(walls).astype(np.float32)


def test_projection_zbuffer_matches_jax():
    """The z-buffer: nearest return per pixel, the same image to the bit."""
    rng = np.random.RandomState(5)
    xyz = np.concatenate([room_cloud(rng), [[5.0, 0, 0], [9.0, 0.001, 0.001], [-3, 0, 0]]])
    xyz = xyz.astype(np.float32)
    valid = rng.rand(len(xyz)) > 0.05
    valid[-3:] = True
    args = (100, 60, 50.0, 50.0, 50.0, 30.0)
    it = tri.project_range_image(torch.from_numpy(xyz), torch.from_numpy(valid), *args)
    ij = jri.project_range_image(jnp.asarray(xyz), jnp.asarray(valid), *args)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert 4.0 <= float(it[30, 50]) < 4.01  # the wall at x = 4 hides the points behind it


@pytest.mark.parametrize("xyz_ypr", [(0.0,) * 6, (0.15, -0.1, 0.05, 0.04, 0.02, -0.01),
                                     (3.0, 1.0, 0.0, 0.6, 0.0, 0.0)])
def test_range_image_quality_matches_jax(xyz_ypr):
    rng = np.random.RandomState(7)
    g = room_cloud(rng, n=800)
    pj, pt = _pose(xyz_ypr)
    loc = (se3.apply(se3.inverse(pt), torch.from_numpy(g)).numpy()
           + 0.02 * rng.randn(*g.shape)).astype(np.float32)
    qj = float(jri.QualityRangeImageSimilarity().evaluate(
        None, global_map={"raw": JPointCloud.from_numpy(g)},
        local_map={"raw": JPointCloud.from_numpy(loc)}, pose=pj).quality)
    qt = float(tri.QualityRangeImageSimilarity().evaluate(
        None, global_map={"raw": PointCloud.from_numpy(g)},
        local_map={"raw": PointCloud.from_numpy(loc)}, pose=pt).quality)
    assert qt == pytest.approx(qj, abs=1e-5)


def test_identical_clouds_score_high():
    pc = PointCloud.from_numpy(room_cloud(np.random.RandomState(0)))
    q = tri.QualityRangeImageSimilarity()
    same = float(q.evaluate_clouds(pc, pc, se3.identity()).quality)
    bad = float(q.evaluate_clouds(pc, pc, se3.from_xyz_ypr(3.0, 1.0, 0, 0.6, 0, 0)).quality)
    assert same > bad and same > 0.8


def test_range_image_without_raw_scores_half():
    q = tri.QualityRangeImageSimilarity()
    out = q.evaluate(None, global_map={"map": PointCloud.from_numpy(np.zeros((4, 3)))},
                     local_map={"raw": PointCloud.from_numpy(np.zeros((4, 3)))},
                     pose=se3.identity())
    assert float(out.quality) == 0.5 and not bool(out.hard_discard)
