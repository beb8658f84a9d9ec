"""Parity of the port's filters with the JAX package on the CPU: the same
numpy inputs go through both.

- FilterDeskew: atol 1e-5 m at +-60 m coordinates, at twists with |w| = 0,
  1e-9 and ~0.5 rad/s;
- FirstPoint decimation, backend ``sort``: the selection, the count, xyz and
  the channels equal row for row (exact); backend ``hash``: the same winners
  as ``sort``, rows in input order, equal to the JAX package's (exact);
- FilterMerge: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.filters import apply_filter_pipeline as japply
from mp2p_icp_tpu.filters.decimate_voxels import DecimateMethod as JMethod
from mp2p_icp_tpu.filters.decimate_voxels import FilterDecimateVoxels as JDecimate
from mp2p_icp_tpu.filters.deskew import FilterDeskew as JDeskew
from mp2p_icp_tpu.filters.merge import FilterMerge as JMerge
from mp2p_icp_tpu.ops.voxel_unique import first_point_select as jselect
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core.metric_map import MetricMap
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters import (
    DecimateMethod,
    FilterBase,
    FilterDecimateVoxels,
    FilterDeskew,
    FilterMerge,
    apply_filter_pipeline,
)
from mp2p_icp_tpu_torch.ops.voxel_unique import first_point_select


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


CHANNELS = ("intensity", "ring", "time", "normals")


def _clouds(seed, n, cap, spread=60.0, channels=True, normals=False):
    """The same cloud in both packages: n points in +-spread, capacity cap."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    ch = {}
    if channels:
        ch = {"intensity": rng.rand(n).astype(np.float32),
              "ring": rng.randint(0, 16, n).astype(np.float32),
              "time": rng.uniform(-0.05, 0.05, n).astype(np.float32)}
    pj = JPointCloud.from_numpy(xyz, capacity=cap, **ch)
    if normals:
        nrm = np.zeros((cap, 3), np.float32)
        nrm[:n] = rng.randn(n, 3)
        pj = pj.__class__(**{**{f: getattr(pj, f) for f in ("xyz", "count") + CHANNELS[:3]},
                             "normals": jnp.asarray(nrm)})
    return pj, convert.pointcloud_from_jax(pj)


def assert_clouds_equal(pj, pt, atol=0.0):
    assert int(pj.count) == int(pt.count)
    np.testing.assert_allclose(pt.xyz.numpy(), np.asarray(pj.xyz), rtol=0, atol=atol)
    for name in CHANNELS:
        a, b = getattr(pj, name), getattr(pt, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


# ------------------------------------------------------------------ deskew
@pytest.mark.parametrize("twist", [
    (9.5, 0.4, -0.1, 0.0, 0.0, 0.0),  # |w| = 0
    (9.5, 0.4, -0.1, 1e-9, 0.0, 0.0),  # |w| = 1e-9: below the small-angle switch
    (9.5, 0.4, -0.1, 0.05, -0.1, 0.48),  # |w| ~ 0.5 rad/s
])
@pytest.mark.parametrize("as_variables", [False, True])
def test_deskew_matches_jax(twist, as_variables):
    pj, pt = _clouds(3, 3000, 4096)
    if as_variables:
        names = ("vx", "vy", "vz", "wx", "wy", "wz")
        vj = dict(zip(names, jnp.asarray(twist, jnp.float32)))
        vt = dict(zip(names, torch.tensor(twist)))  # 0-d tensors, as the mapper passes them
        oj, ot = JDeskew()({"raw": pj}, vj), FilterDeskew()({"raw": pt}, vt)
    else:
        oj, ot = JDeskew(twist=twist)({"raw": pj}), FilterDeskew(twist=twist)({"raw": pt})
    assert_clouds_equal(oj["deskewed"], ot["deskewed"], atol=1e-5)
    moved = np.abs(ot["deskewed"].xyz.numpy()[:3000] - pt.xyz.numpy()[:3000]).max()
    assert 0.3 < moved < 3.0  # ~10 m/s and up to 0.5 rad/s at 100 m, over +-0.05 s
    assert (ot["deskewed"].xyz[3000:] == PointCloud.PAD_VALUE).all()
    assert ot["raw"] is pt


def test_deskew_without_timestamps():
    _, pt = _clouds(4, 100, 256, channels=False)
    with pytest.raises(ValueError, match="no per-point timestamps"):
        FilterDeskew()({"raw": pt})
    out = FilterDeskew(silently_ignore_no_timestamps=True)({"raw": pt})
    assert out["deskewed"] is pt


def test_deskew_trajectory_mode_raises():
    _, pt = _clouds(4, 100, 256)
    variables = {"trajectory_times": torch.zeros(2), "trajectory_tangents": torch.zeros(2, 6)}
    with pytest.raises(NotImplementedError, match="trajectory"):
        FilterDeskew(method="trajectory")({"raw": pt}, variables)
    # without the trajectory variables the mode falls back to the constant twist
    out = FilterDeskew(use_precise_local_velocities=True)({"raw": pt}, {"vx": 1.0})
    assert out["deskewed"].xyz.shape == pt.xyz.shape


# -------------------------------------------------------------- first point
@pytest.mark.parametrize("n,cap,out_cap,flatten", [
    (3000, 4096, 4096, False), (3000, 4096, 512, False), (3000, 4096, 1024, True),
    (0, 256, 256, False),
])
def test_first_point_select_matches_jax(n, cap, out_cap, flatten):
    pj, pt = _clouds(5, n, cap, spread=8.0)
    # an explicit mask with holes, not only the leading rows
    valid = np.asarray(pj.valid_mask()) & (np.random.RandomState(6).rand(cap) > 0.2)
    sj, nj = jselect(pj.xyz, jnp.asarray(valid), 1.0, out_cap, flatten_z=flatten)
    st, nt = first_point_select(pt.xyz, torch.from_numpy(valid), 1.0, out_cap, flatten_z=flatten)
    assert int(nj) == int(nt)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("kwargs", [
    dict(voxel_filter_resolution=1.0),
    dict(voxel_filter_resolution=0.5, output_capacity=1024),
    dict(voxel_filter_resolution=2.0, flatten_to=0.25),
    dict(voxel_filter_resolution=1.0, minimum_input_points_to_filter=500),
], ids=["plain", "capped", "flatten", "bypass_not_taken"])
def test_decimate_first_point_sort_matches_jax(kwargs):
    pj, pt = _clouds(7, 3000, 4096, spread=10.0)
    oj = JDecimate(input_pointcloud_layer=("raw",), **kwargs)({"raw": pj})["decimated"]
    ot = FilterDecimateVoxels(input_pointcloud_layer=("raw",), **kwargs)({"raw": pt})["decimated"]
    assert_clouds_equal(oj, ot)
    assert 0 < int(ot.count) < 3000


def test_decimate_two_layers_with_bypass_matches_jax():
    """Two input layers: the small one (<= minimum) is copied through after
    the decimated block of the large one."""
    aj, at = _clouds(8, 3000, 4096, spread=10.0)
    bj, bt = _clouds(9, 40, 256, spread=10.0)
    kwargs = dict(input_pointcloud_layer=("a", "b"), voxel_filter_resolution=1.0,
                  minimum_input_points_to_filter=50, output_capacity=4096)
    oj = JDecimate(**kwargs)({"a": aj, "b": bj})["decimated"]
    ot = FilterDecimateVoxels(**kwargs)({"a": at, "b": bt})["decimated"]
    assert_clouds_equal(oj, ot)
    n = int(ot.count)
    np.testing.assert_array_equal(ot.xyz.numpy()[n - 40:n], bt.xyz.numpy()[:40])
    with pytest.raises(ValueError, match="overflow"):
        FilterDecimateVoxels(**{**kwargs, "output_capacity": 64})({"a": at, "b": bt})


def test_decimate_hash_backend_matches_jax_and_sort():
    pj, pt = _clouds(10, 3000, 4096, spread=10.0)
    kwargs = dict(input_pointcloud_layer=("raw",), voxel_filter_resolution=1.0,
                  output_capacity=4096)
    oj = JDecimate(backend="hash", **kwargs)({"raw": pj})["decimated"]
    oh = FilterDecimateVoxels(backend="hash", **kwargs)({"raw": pt})["decimated"]
    os_ = FilterDecimateVoxels(backend="sort", **kwargs)({"raw": pt})["decimated"]
    assert_clouds_equal(oj, oh)
    n = int(oh.count)
    assert n == int(os_.count)
    # the same winners as the sort backend, in input order
    rows_h, rows_s = oh.xyz.numpy()[:n], os_.xyz.numpy()[:n]
    np.testing.assert_array_equal(np.unique(rows_h, axis=0), np.unique(rows_s, axis=0))
    src = pt.xyz.numpy()[:3000]
    where = [int(np.nonzero((src == r).all(1))[0][0]) for r in rows_h[:200]]
    assert where == sorted(where)


def test_decimate_options_that_raise():
    _, pt = _clouds(11, 100, 256)
    for method in (DecimateMethod.RANDOM_POINT, DecimateMethod.VOXEL_AVERAGE,
                   DecimateMethod.CLOSEST_TO_AVERAGE):
        with pytest.raises(NotImplementedError, match="not ported"):
            FilterDecimateVoxels(decimate_method=method)({"raw": pt})
    with pytest.raises(ValueError, match="FIRST_POINT only"):
        FilterDecimateVoxels(backend="hash", decimate_method=DecimateMethod.VOXEL_AVERAGE)(
            {"raw": pt})
    with pytest.raises(ValueError, match="flatten_to"):
        FilterDecimateVoxels(backend="hash", flatten_to=0.0)({"raw": pt})
    with pytest.raises(ValueError, match="minimum_input_points"):
        FilterDecimateVoxels(backend="hash", minimum_input_points_to_filter=5)({"raw": pt})
    assert DecimateMethod.from_string("DecimateMethod::FirstPoint") is DecimateMethod.FIRST_POINT
    assert {m.value for m in DecimateMethod} == {m.value for m in JMethod}


# -------------------------------------------------------------------- merge
@pytest.mark.parametrize("case", ["new_target", "append", "overflow", "robot_pose"])
def test_merge_matches_jax(case):
    sj, st = _clouds(12, 700, 1024, normals=True)
    layers_j, layers_t = {"raw": sj}, {"raw": st}
    kwargs, variables_j, variables_t = dict(target_capacity=2048), None, None
    if case != "new_target":
        n = 1500 if case == "overflow" else 300
        tj, tt = _clouds(13, n, 2048, channels=(case == "append"))
        layers_j["map"], layers_t["map"] = tj, tt
    if case == "robot_pose":
        kwargs["use_robot_pose"] = True
        variables_j = {"robot_x": 1.0, "robot_y": -2.0, "robot_yaw": 0.3, "robot_roll": 0.05}
        variables_t = {k: torch.tensor(v) for k, v in variables_j.items()}
    oj = JMerge(**kwargs)(layers_j, variables_j)["map"]
    ot = FilterMerge(**kwargs)(layers_t, variables_t)["map"]
    if case == "robot_pose":  # the pose is built in f32 by each package
        assert int(oj.count) == int(ot.count) == 1000
        np.testing.assert_allclose(ot.xyz.numpy(), np.asarray(oj.xyz), atol=1e-4)
        np.testing.assert_allclose(ot.normals.numpy(), np.asarray(oj.normals), atol=1e-5)
    else:
        assert_clouds_equal(oj, ot)
    assert int(ot.count) == {"new_target": 700, "append": 1000, "overflow": 2048,
                             "robot_pose": 1000}[case]


# ----------------------------------------------------------------- pipeline
def test_pipeline_runs_filters_in_order():
    pj, pt = _clouds(14, 3000, 4096, spread=10.0)
    twist = (9.0, 0.0, 0.0, 0.0, 0.0, 0.3)
    fj = [JDeskew(twist=twist), JDecimate(input_pointcloud_layer=("deskewed",),
                                          voxel_filter_resolution=1.0)]
    ft = [FilterDeskew(twist=twist), FilterDecimateVoxels(
        input_pointcloud_layer=("deskewed",), voxel_filter_resolution=1.0)]
    oj, ot = japply(fj, {"raw": pj}), apply_filter_pipeline(ft, {"raw": pt})
    assert sorted(ot) == sorted(oj) == ["decimated", "deskewed", "raw"]
    # the deskewed coordinates agree to 1e-5, so a point within that of a
    # voxel border may fall on either side: compare the counts closely
    assert abs(int(ot["decimated"].count) - int(oj["decimated"].count)) <= 3
    # a MetricMap is updated in place and gives the same layers
    mm = MetricMap(layers={"raw": pt})
    assert apply_filter_pipeline(ft, mm) is mm
    assert sorted(mm.layers) == sorted(ot)
    assert torch.equal(mm.layers["decimated"].xyz, ot["decimated"].xyz)
    with pytest.raises(TypeError, match="MetricMap"):
        apply_filter_pipeline(ft, object())
    with pytest.raises(NotImplementedError):
        FilterBase()({"raw": pt})
