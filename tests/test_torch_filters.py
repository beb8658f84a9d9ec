"""Parity of the port's filters with the JAX package on the CPU: the same
numpy inputs go through both.

- FilterDeskew: atol 1e-5 m at +-60 m coordinates, at twists with |w| = 0,
  1e-9 and ~0.5 rad/s;
- FirstPoint decimation, backend ``sort``: the selection, the count, xyz and
  the channels equal row for row (exact); backend ``hash``: the same winners
  as ``sort``, rows in input order, equal to the JAX package's (exact);
- FilterMerge: exact;
- the row filters (range, bounding box, ring, intensity and its
  normalisation, timestamps, delete layer): exact;
- ``voxel_segments``, RandomPoint, VoxelAverage (means summed in sorted
  order: bit-equal here, 1e-6 relative is the band), ClosestToAverage and
  both variants: exact. The ClosestToAverage tie rule: a voxel's winner may
  differ from the JAX package's only where the two candidates' d² lie
  within 1e-6 m² of each other; the test lists such voxels (none on these
  inputs);
- the precise deskew along a trajectory: 1e-5 m;
- FilterEstimateNormals: the rows and their coordinates exact, the normals
  within the band of test_torch_normals.py;
- the voxel filters: voxel keys exact, occupancy 1e-6, the static /
  dynamic split exact away from the threshold.
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
from mp2p_icp_tpu.ops.voxel_unique import voxel_segments as jsegments
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
from mp2p_icp_tpu_torch.ops.voxel_unique import (
    first_point_select,
    segment_sums_in_order,
    voxel_segments,
)


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
    """The precise mode (once refused) along a trajectory: rotation
    interpolated from the tangents, translation v*t, against the JAX
    package's within 1e-5 m; its legacy alias method == "trajectory" is the
    same mode; without the trajectory it falls back to the constant twist."""
    pj, pt = _clouds(4, 3000, 4096)
    times = np.linspace(-0.06, 0.06, 25)
    tangents = np.zeros((25, 6))
    tangents[:, 3:] = np.outer(np.sign(times) * times ** 2 * 40.0, [0.1, -0.2, 1.0])
    tangents[:, :3] = np.outer(times, [9.0, 0.3, 0.0])
    variables = {"vx": 9.5, "vy": 0.4, "vz": -0.1, "trajectory_times": times,
                 "trajectory_tangents": tangents}
    oj = JDeskew(use_precise_local_velocities=True)({"raw": pj}, variables)["deskewed"]
    for f in (FilterDeskew(use_precise_local_velocities=True), FilterDeskew(method="trajectory")):
        ot = f({"raw": pt}, variables)["deskewed"]
        assert_clouds_equal(oj, ot, atol=1e-5)
    const = FilterDeskew()({"raw": pt}, variables)["deskewed"]
    assert np.abs(const.xyz.numpy()[:3000] - ot.xyz.numpy()[:3000]).max() > 1e-2
    # without the trajectory variables the mode falls back to the constant twist
    out = FilterDeskew(use_precise_local_velocities=True)({"raw": pt}, {"vx": 1.0})
    assert torch.equal(out["deskewed"].xyz, FilterDeskew()({"raw": pt}, {"vx": 1.0})["deskewed"].xyz)


def _batch_of_clouds(seeds, n_points, cap):
    """B clouds of one capacity, each in both packages, and their stack in
    each: ([JAX clouds], [port clouds], JAX batch, port batch)."""
    pairs = [_clouds(s, n, cap, spread=8.0) for s, n in zip(seeds, n_points)]
    js, ts = [p[0] for p in pairs], [p[1] for p in pairs]
    jb = JPointCloud(**{f: jnp.stack([getattr(c, f) for c in js])
                        for f in ("xyz", "count") + CHANNELS[:3]})
    tb = PointCloud(**{f: torch.stack([getattr(c, f) for c in ts])
                       for f in ("xyz", "count") + CHANNELS[:3]})
    return js, ts, jb, tb


@pytest.mark.parametrize("method", ["RandomPoint", "VoxelAverage", "ClosestToAverage"])
def test_decimate_batch_equals_single_calls(method):
    """A batch of clouds [B, C, 3] (no longer refused beyond FirstPoint):
    each cloud to the bit as its own call, and as jax.vmap of the JAX
    filter with unbatched parameters (the bands of the single-cloud cases:
    exact; VoxelAverage's means 1e-6 relative)."""
    import jax

    js, ts, jb, tb = _batch_of_clouds((30, 31, 32), (900, 0, 1500), 2048)
    f = FilterDecimateVoxels(decimate_method=DecimateMethod(method), output_capacity=1024)
    out = f({"raw": tb})["decimated"]
    assert out.xyz.shape == (3, 1024, 3) and out.count.shape == (3,)
    jf = JDecimate(decimate_method=JMethod(method), output_capacity=1024)
    ojb = jax.vmap(lambda pc: jf({"raw": pc})["decimated"])(jb)
    for b, pc in enumerate(ts):
        single = f({"raw": pc})["decimated"]
        for name in ("xyz", "count") + CHANNELS[:3]:
            a, c = getattr(out, name), getattr(single, name)
            assert (a is None) == (c is None), name
            if c is not None:
                assert torch.equal(a[b], c), (b, name)
        got, want = out.xyz[b].numpy(), np.asarray(ojb.xyz[b])
        assert int(out.count[b]) == int(ojb.count[b])
        if method == "VoxelAverage":
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
    assert int(out.count[1]) == 0 and int(out.count[2]) > int(out.count[0]) > 0


def test_precise_deskew_batch_equals_single_calls():
    """The precise deskew on a batch of clouds (no longer refused), one
    twist per cloud and a shared trajectory: each cloud to the bit as its
    own call, and within 1e-5 m of jax.vmap of the JAX filter."""
    import jax

    js, ts, jb, tb = _batch_of_clouds((33, 34), (3000, 2500), 4096)
    times = np.linspace(-0.06, 0.06, 25)
    tangents = np.zeros((25, 6))
    tangents[:, 3:] = np.outer(np.sign(times) * times ** 2 * 40.0, [0.1, -0.2, 1.0])
    tangents[:, :3] = np.outer(times, [9.0, 0.3, 0.0])
    vx = np.array([9.5, 4.0], np.float32)
    traj = {"trajectory_times": times, "trajectory_tangents": tangents}
    f = FilterDeskew(use_precise_local_velocities=True)
    out = f({"raw": tb}, {"vx": torch.from_numpy(vx), "vy": 0.4, **traj})["deskewed"]
    jf = JDeskew(use_precise_local_velocities=True)
    ojb = jax.vmap(lambda pc, v: jf({"raw": pc}, {"vx": v, "vy": 0.4, **traj})["deskewed"])(
        jb, jnp.asarray(vx))
    for b, pc in enumerate(ts):
        single = f({"raw": pc}, {"vx": float(vx[b]), "vy": 0.4, **traj})["deskewed"]
        assert torch.equal(out.xyz[b], single.xyz), b
        np.testing.assert_allclose(out.xyz[b].numpy(), np.asarray(ojb.xyz[b]), rtol=0, atol=1e-5)


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
    """The methods once refused now decimate as the JAX package does (the
    parity cases below), a batch of clouds beyond FirstPoint too (a batch of
    one here; test_decimate_batch_equals_single_calls); what still raises is
    the hash backend's refusal of the options it does not take."""
    pj, pt = _clouds(11, 100, 256)
    for method in (DecimateMethod.RANDOM_POINT, DecimateMethod.VOXEL_AVERAGE,
                   DecimateMethod.CLOSEST_TO_AVERAGE):
        oj = JDecimate(decimate_method=JMethod(method.value))({"raw": pj})["decimated"]
        ot = FilterDecimateVoxels(decimate_method=method)({"raw": pt})["decimated"]
        assert_clouds_equal(oj, ot)
        batch = PointCloud(xyz=pt.xyz[None], count=pt.count[None])
        ob = FilterDecimateVoxels(decimate_method=method)({"raw": batch})["decimated"]
        assert torch.equal(ob.xyz[0], ot.xyz) and torch.equal(ob.count[0], ot.count)
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


# --------------------------------------------------------------- row filters
def _layers_equal(oj, ot, names):
    for name in names:
        assert_clouds_equal(oj[name], ot[name])


@pytest.mark.parametrize("variables", [None, {"robot_x": 3.0, "robot_y": -2.0, "robot_z": 0.5}])
def test_by_range_matches_jax(variables):
    from mp2p_icp_tpu.filters.by_range import FilterByRange as JF
    from mp2p_icp_tpu_torch.filters.by_range import FilterByRange

    pj, pt = _clouds(20, 3000, 4096, spread=30.0)
    kw = dict(output_layer_between="in", output_layer_outside="out", range_min=5.0,
              range_max=25.0, center=(1.0, 1.0, 0.0))
    vt = None if variables is None else {k: torch.tensor(v) for k, v in variables.items()}
    oj, ot = JF(**kw)({"raw": pj}, variables), FilterByRange(**kw)({"raw": pt}, vt)
    _layers_equal(oj, ot, ("in", "out"))
    assert 0 < int(ot["in"].count) < 3000
    assert int(ot["in"].count) + int(ot["out"].count) == 3000
    assert ot["in"].normals is None  # compact keeps I/R/T, not normals, as JAX


def test_bounding_box_ring_intensity_timestamps_delete_match_jax():
    from mp2p_icp_tpu.filters import (FilterAdjustTimestamps as JAdjust, FilterBoundingBox as JBox,
                                      FilterByIntensity as JInt, FilterByRing as JRing,
                                      FilterDeleteLayer as JDel,
                                      FilterNormalizeIntensity as JNorm)
    from mp2p_icp_tpu.filters.adjust_timestamps import TimestampAdjustMethod as JTM
    from mp2p_icp_tpu_torch.filters.adjust_timestamps import (FilterAdjustTimestamps,
                                                              TimestampAdjustMethod)
    from mp2p_icp_tpu_torch.filters.bounding_box import FilterBoundingBox
    from mp2p_icp_tpu_torch.filters.by_intensity import (FilterByIntensity,
                                                         FilterNormalizeIntensity)
    from mp2p_icp_tpu_torch.filters.by_ring import FilterByRing
    from mp2p_icp_tpu_torch.filters.delete_layer import FilterDeleteLayer

    pj, pt = _clouds(21, 3000, 4096, spread=20.0)
    cases = [
        (JBox(inside_pointcloud_layer="in", outside_pointcloud_layer="out",
              bbox_min=(-5.0, -10.0, -2.0), bbox_max=(5.0, 10.0, 8.0)),
         FilterBoundingBox(inside_pointcloud_layer="in", outside_pointcloud_layer="out",
                           bbox_min=(-5.0, -10.0, -2.0), bbox_max=(5.0, 10.0, 8.0)), ("in", "out")),
        (JRing(output_layer_selected="sel", output_layer_non_selected="rest",
               selected_ring_ids=(0, 3, 15)),
         FilterByRing(output_layer_selected="sel", output_layer_non_selected="rest",
                      selected_ring_ids=(0, 3, 15)), ("sel", "rest")),
        (JInt(output_layer_low_intensity="lo", output_layer_mid_intensity="mid",
              output_layer_high_intensity="hi", low_threshold=0.3, high_threshold=0.6),
         FilterByIntensity(output_layer_low_intensity="lo", output_layer_mid_intensity="mid",
                           output_layer_high_intensity="hi", low_threshold=0.3,
                           high_threshold=0.6), ("lo", "mid", "hi")),
        (JNorm(), FilterNormalizeIntensity(), ("raw",)),
    ] + [(JAdjust(method=JTM(m.value), time_offset=0.25),
          FilterAdjustTimestamps(method=m, time_offset=0.25), ("raw",))
         for m in TimestampAdjustMethod]
    for fj, ft, names in cases:
        oj, ot = fj({"raw": pj}), ft({"raw": pt})
        _layers_equal(oj, ot, names)
        assert sorted(ot) == sorted(oj)
    oj = JDel(pointcloud_layer_to_remove=("raw",))({"raw": pj, "x": pj})
    ot = FilterDeleteLayer(pointcloud_layer_to_remove=("raw",))({"raw": pt, "x": pt})
    assert sorted(ot) == sorted(oj) == ["x"]
    with pytest.raises(KeyError):
        FilterDeleteLayer(pointcloud_layer_to_remove=("y",))({"raw": pt})
    assert FilterDeleteLayer(pointcloud_layer_to_remove=("y",),
                             error_on_missing_input_layer=False)({"raw": pt}) == {"raw": pt}
    _, bare = _clouds(22, 10, 256, channels=False)
    for f in (FilterByRing(), FilterByIntensity(), FilterNormalizeIntensity(),
              FilterAdjustTimestamps()):
        with pytest.raises(ValueError, match="no "):
            f({"raw": bare})
    assert FilterAdjustTimestamps(silently_ignore_no_timestamps=True)({"raw": bare})["raw"] is bare


# ----------------------------------------------------- voxel segments, methods
@pytest.mark.parametrize("flatten", [False, True])
def test_voxel_segments_match_jax(flatten):
    pj, pt = _clouds(23, 3000, 4096, spread=8.0)
    valid = np.asarray(pj.valid_mask()) & (np.random.RandomState(24).rand(4096) > 0.2)
    sj = jsegments(pj.xyz, jnp.asarray(valid), 1.0, flatten_z=flatten)
    st = voxel_segments(pt.xyz, torch.from_numpy(valid), 1.0, flatten_z=flatten)
    for field in sj._fields:
        np.testing.assert_array_equal(getattr(st, field).numpy(), np.asarray(getattr(sj, field)),
                                      err_msg=field)


@pytest.mark.parametrize("n", [0, 4096])
def test_segment_sums_add_each_voxel_row_by_row(n):
    """segment_sums_in_order: each voxel's rows added one by one in sorted
    order from 0 in float32, bit for bit (a voxel of ~1000 rows makes the
    order show), the invalid rows left out; [C] and [C, 3] values."""
    rng = np.random.RandomState(29)
    xyz = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    xyz[: n // 4] = rng.uniform(0.0, 0.9, (n // 4, 3))  # one long voxel
    valid = rng.rand(n) > 0.2
    segs = voxel_segments(torch.from_numpy(xyz), torch.from_numpy(valid), 1.0)
    rows = torch.from_numpy(xyz)[segs.order]
    for values in (rows, rows[:, 0].contiguous()):
        got = segment_sums_in_order(values, segs, n)
        want = torch.zeros_like(values)
        for i in range(n):
            if segs.valid[i]:
                want[segs.segment_id[i]] += values[i]
        assert got.shape == values.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize("method", ["RandomPoint", "VoxelAverage", "ClosestToAverage"])
@pytest.mark.parametrize("kwargs", [
    dict(voxel_filter_resolution=1.0),
    dict(voxel_filter_resolution=0.5, output_capacity=1024),
    dict(voxel_filter_resolution=2.0, flatten_to=0.25),
    dict(voxel_filter_resolution=1.0, minimum_input_points_to_filter=500),
], ids=["plain", "capped", "flatten", "bypass_not_taken"])
def test_decimate_methods_match_jax(method, kwargs):
    pj, pt = _clouds(25, 3000, 4096, spread=10.0)
    oj = JDecimate(input_pointcloud_layer=("raw",), decimate_method=JMethod(method),
                   **kwargs)({"raw": pj})["decimated"]
    ot = FilterDecimateVoxels(input_pointcloud_layer=("raw",),
                              decimate_method=DecimateMethod(method), **kwargs)(
        {"raw": pt})["decimated"]
    if method == "VoxelAverage":  # the band of a mean; the sums run in the same order
        np.testing.assert_allclose(ot.xyz.numpy(), np.asarray(oj.xyz), rtol=1e-6)
        ot = PointCloud(**{**ot.__dict__, "xyz": torch.from_numpy(np.array(oj.xyz))})
    assert_clouds_equal(oj, ot)
    assert 0 < int(ot.count) < 3000


def test_decimate_two_layers_with_bypass_all_methods_match_jax():
    aj, at = _clouds(26, 3000, 4096, spread=10.0)
    bj, bt = _clouds(27, 40, 256, spread=10.0)
    for method in ("RandomPoint", "VoxelAverage", "ClosestToAverage"):
        kwargs = dict(input_pointcloud_layer=("a", "b"), voxel_filter_resolution=1.0,
                      minimum_input_points_to_filter=50, output_capacity=4096)
        oj = JDecimate(decimate_method=JMethod(method), **kwargs)({"a": aj, "b": bj})["decimated"]
        ot = FilterDecimateVoxels(decimate_method=DecimateMethod(method), **kwargs)(
            {"a": at, "b": bt})["decimated"]
        assert_clouds_equal(oj, ot)


@pytest.mark.parametrize("grid", [False, True], ids=["uniform", "integer_grid_ties"])
def test_closest_to_average_winners_and_tie_rows(grid):
    """ClosestToAverage: the winners equal the JAX package's row for row,
    except voxels whose two candidates' d² (to the JAX mean) lie within
    1e-6 m² of each other; those are listed. On points of an integer grid
    (exact duplicates, equal distances) the tie rule decides: the lowest
    source row, in both packages."""
    rng = np.random.RandomState(28)
    n = 3000
    xyz = (rng.randint(0, 12, (n, 3)) * 0.25 if grid else rng.uniform(-6, 6, (n, 3)))
    pj = JPointCloud.from_numpy(xyz.astype(np.float32), capacity=4096)
    pt = convert.pointcloud_from_jax(pj)
    kw = dict(input_pointcloud_layer=("raw",), voxel_filter_resolution=1.0)
    oj = JDecimate(decimate_method=JMethod.CLOSEST_TO_AVERAGE, **kw)({"raw": pj})["decimated"]
    ot = FilterDecimateVoxels(decimate_method=DecimateMethod.CLOSEST_TO_AVERAGE, **kw)(
        {"raw": pt})["decimated"]
    means = JDecimate(decimate_method=JMethod.VOXEL_AVERAGE, **kw)({"raw": pj})["decimated"]
    k = int(oj.count)
    assert k == int(ot.count) > 0
    a, b, m = np.asarray(oj.xyz)[:k], ot.xyz.numpy()[:k], np.asarray(means.xyz)[:k]
    differ = np.nonzero((a != b).any(1))[0]
    ties = [int(i) for i in differ
            if abs(((a[i] - m[i]) ** 2).sum() - ((b[i] - m[i]) ** 2).sum()) <= 1e-6]
    assert list(differ) == ties, f"winners differ outside the tie rows: {set(differ) - set(ties)}"
    assert ties == []  # the listed tie rows on these inputs


def test_decimate_variants_match_jax():
    from mp2p_icp_tpu.filters.decimate_variants import (FilterDecimateAdaptive as JA,
                                                        FilterDecimateVoxelsQuadratic as JQ)
    from mp2p_icp_tpu_torch.filters.decimate_variants import (FilterDecimateAdaptive,
                                                              FilterDecimateVoxelsQuadratic)

    pj, pt = _clouds(29, 3000, 4096, spread=40.0)
    for fj, ft in ((JQ(voxel_filter_resolution=0.2), FilterDecimateVoxelsQuadratic(
                        voxel_filter_resolution=0.2)),
                   (JQ(voxel_filter_resolution=0.5, quadratic_reference_radius=5.0),
                    FilterDecimateVoxelsQuadratic(voxel_filter_resolution=0.5,
                                                  quadratic_reference_radius=5.0)),
                   (JA(desired_output_point_count=300), FilterDecimateAdaptive(
                       desired_output_point_count=300)),
                   (JA(desired_output_point_count=50, maximum_voxel_count_per_dimension=4),
                    FilterDecimateAdaptive(desired_output_point_count=50,
                                           maximum_voxel_count_per_dimension=4))):
        oj, ot = fj({"raw": pj})["decimated"], ft({"raw": pt})["decimated"]
        assert int(oj.count) == int(ot.count) > 0
        np.testing.assert_array_equal(ot.xyz.numpy(), np.asarray(oj.xyz))


# ------------------------------------------------------------ normals filter
def test_estimate_normals_filter_matches_jax():
    """The filter over ops.normals: the same rows; the normals of the JAX
    package within 1e-3 (with sign) on all but a few rows, as
    test_torch_normals.py holds the fit (near-degenerate spectra differ)."""
    from mp2p_icp_tpu.filters.estimate_normals import FilterEstimateNormals as JN
    from mp2p_icp_tpu_torch.filters.estimate_normals import FilterEstimateNormals

    rng = np.random.RandomState(30)
    n = 1500
    plane = np.stack([rng.uniform(-5, 5, n), rng.uniform(-5, 5, n),
                      0.01 * rng.randn(n)], 1).astype(np.float32)
    wall = np.stack([rng.uniform(-5, 5, n), np.full(n, 3.0), rng.uniform(0, 3, n)], 1)
    xyz = np.concatenate([plane, wall.astype(np.float32)])
    pj = JPointCloud.from_numpy(xyz, capacity=4096)
    pt = convert.pointcloud_from_jax(pj)
    for kw in (dict(), dict(output_pointcloud_layer="with_normals", knn=6, max_radius=1.0),
               dict(source_pointcloud_layer="raw", input_pointcloud_layer="raw")):
        kw.setdefault("input_pointcloud_layer", "raw")
        oj, ot = JN(**kw)({"raw": pj}), FilterEstimateNormals(**kw)({"raw": pt})
        name = kw.get("output_pointcloud_layer") or "raw"
        nj, nt = np.asarray(oj[name].normals), ot[name].normals.numpy()
        np.testing.assert_array_equal(ot[name].xyz.numpy(), np.asarray(oj[name].xyz))
        bad = np.abs(nj - nt).max(1) > 1e-3
        assert bad.sum() <= 0.01 * len(xyz), bad.sum()
        assert (np.abs(nt[:len(xyz)]).sum(1) > 0).mean() > 0.9


# ------------------------------------------------------------- voxel filters
def _voxel_pair(seed, n=2000, capacity=8192, res=0.5):
    from mp2p_icp_tpu.core.metric_map import VoxelGridLayer as JV
    from mp2p_icp_tpu.ops.voxel_occupancy import update_voxel_map as jupdate

    pj, pt = _clouds(seed, n, 4096, spread=6.0)
    vj = jupdate(JV.empty(capacity, res), pj.xyz, pj.valid_mask(), jnp.asarray([0.5, 0.2, 0.1]))
    return pj, pt, vj, convert.voxel_grid_from_jax(vj)


def assert_grids_equal(vj, vt):
    np.testing.assert_array_equal(vt.valid.numpy(), np.asarray(vj.valid))
    np.testing.assert_array_equal(vt.keys.numpy(), np.asarray(vj.keys))
    np.testing.assert_allclose(vt.occupancy.numpy(), np.asarray(vj.occupancy), atol=1e-6)


@pytest.mark.parametrize("threshold", [0.4, 0.6])
def test_remove_by_voxel_occupancy_matches_jax(threshold):
    from mp2p_icp_tpu.filters.voxel_filters import FilterRemoveByVoxelOccupancy as JF
    from mp2p_icp_tpu.ops.voxel_occupancy import lookup_occupancy as jlookup
    from mp2p_icp_tpu_torch.filters.voxel_filters import FilterRemoveByVoxelOccupancy

    pj, pt, vj, vt = _voxel_pair(31)
    qj, qt = _clouds(32, 3000, 4096, spread=6.0)
    kw = dict(output_layer_static_objects="static", output_layer_dynamic_objects="dynamic",
              occupancy_threshold=threshold)
    oj = JF(**kw)({"raw": qj, "voxelmap": vj})
    ot = FilterRemoveByVoxelOccupancy(**kw)({"raw": qt, "voxelmap": vt})
    occ = np.asarray(jlookup(vj, qj.xyz))[:3000]
    near = int((np.abs(occ - threshold) <= 1e-6).sum())
    assert near == 0  # no row on the threshold: the split is exact
    _layers_equal(oj, ot, ("static", "dynamic"))
    assert 0 < int(ot["static"].count) < 3000


def test_voxel_slice_and_occupancy_grid_match_jax():
    from mp2p_icp_tpu.filters.voxel_filters import FilterVoxelSlice as JF
    from mp2p_icp_tpu_torch.filters.voxel_filters import FilterVoxelSlice, OccGrid2D

    _, _, vj, vt = _voxel_pair(33)
    for kw in (dict(), dict(slice_z_min=-1.0, slice_z_max=2.0, grid_half_extent=4.0)):
        gj = JF(**kw)({"voxelmap": vj})["gridmap"]
        gt = FilterVoxelSlice(**kw)({"voxelmap": vt})["gridmap"]
        assert isinstance(gt, OccGrid2D)
        assert gt.origin_xy == gj.origin_xy and gt.resolution == gj.resolution
        np.testing.assert_allclose(gt.occupancy.numpy(), np.asarray(gj.occupancy), atol=1e-6)
        assert (gt.occupancy.numpy() != 0.5).sum() > 0


@pytest.mark.parametrize("carve", [True, False])
def test_generator_voxel_map_matches_jax(carve):
    from mp2p_icp_tpu.filters.voxel_filters import GeneratorVoxelMap as JG
    from mp2p_icp_tpu_torch.core.metric_map import VoxelGridLayer
    from mp2p_icp_tpu_torch.filters.voxel_filters import GeneratorVoxelMap

    pj, pt = _clouds(34, 2000, 4096, spread=6.0)
    kw = dict(resolution=0.5, capacity=8192, ray_samples=16, carve_free_space=carve)
    variables = {"robot_x": 1.0, "robot_y": -0.5, "robot_z": 0.25}
    oj = JG(**kw)({"raw": pj}, variables)
    ot = GeneratorVoxelMap(**kw)({"raw": pt}, {k: torch.tensor(v) for k, v in variables.items()})
    assert isinstance(ot["voxelmap"], VoxelGridLayer)
    assert_grids_equal(oj["voxelmap"], ot["voxelmap"])
    # a second scan accumulates into the layer
    qj, qt = _clouds(35, 1000, 4096, spread=6.0)
    assert_grids_equal(JG(**kw)({"raw": qj, "voxelmap": oj["voxelmap"]})["voxelmap"],
                       GeneratorVoxelMap(**kw)({"raw": qt, "voxelmap": ot["voxelmap"]})["voxelmap"])
