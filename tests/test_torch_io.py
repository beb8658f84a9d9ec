"""The port's file formats against the JAX package's, on the CPU.

Mirrors tests/test_io_apps.py, tests/test_mrpt_mm.py, tests/test_rawlog.py
and tests/test_native.py on generated data:

- round trips of .xyz(.gz), KITTI .bin, .mm.npz and .rawlog.npz;
- a file written by one package loads in the other, array for array;
- the binary MRPT .mm writer is byte for byte the JAX writer (simple, xyzi,
  xyzirt, georeferenced, voxel and multi-layer maps, raw lines and
  planes), and both readers give the same arrays;
- the native text parser and the numpy one parse to the same floats.
"""

import dataclasses
import gzip
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mp2p_icp_tpu_torch
from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.metric_map import (
    Georeferencing as JGeoref,
    MetricMap as JMetricMap,
    PlaneSet as JPlaneSet,
    VoxelGridLayer as JVoxels,
)
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.filters.generator import Observation as JObservation
from mp2p_icp_tpu.io import kitti as jkitti
from mp2p_icp_tpu.io import mm as jmm
from mp2p_icp_tpu.io import mrpt_mm as jmrpt
from mp2p_icp_tpu.io import rawlog as jrawlog
from mp2p_icp_tpu.io import xyz as jxyz
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.metric_map import (
    Georeferencing,
    LineSet,
    MetricMap,
    PlaneSet,
    VoxelGridLayer,
)
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.filters.generator import Observation
from mp2p_icp_tpu_torch.io import kitti, mm, mrpt_mm, native, rawlog, xyz


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _arr(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _clouds_equal(a, b):
    assert int(a.count) == int(b.count)
    np.testing.assert_array_equal(_arr(a.xyz), _arr(b.xyz))
    for ch in ("intensity", "ring", "time"):
        ca, cb = getattr(a, ch), getattr(b, ch)
        assert (ca is None) == (cb is None), ch
        if ca is not None:
            np.testing.assert_array_equal(_arr(ca), _arr(cb), err_msg=ch)


def _maps_equal(a, b):
    assert list(a.layers) == list(b.layers)
    for name in a.layers:
        la, lb = a.layers[name], b.layers[name]
        if hasattr(la, "resolution"):
            assert la.resolution == lb.resolution
            for f in ("keys", "occupancy", "valid"):
                np.testing.assert_array_equal(_arr(getattr(la, f)), _arr(getattr(lb, f)))
        else:
            _clouds_equal(la, lb)
    assert a.id == b.id and a.label == b.label
    ga, gb = a.georeferencing, b.georeferencing
    assert (ga is None) == (gb is None)
    if ga is not None:
        assert dataclasses.asdict(ga) == dataclasses.asdict(gb)
    for raw in ("lines_raw", "planes_raw"):
        ra, rb = getattr(a, raw, None), getattr(b, raw, None)
        assert (ra is None) == (rb is None), raw
        if ra is not None:
            np.testing.assert_array_equal(ra, rb)


def _cloud_arrays(rng, n, channels=()):
    out = {"xyz": (rng.randn(n, 3) * 10).astype(np.float32)}
    if "intensity" in channels:
        out["intensity"] = rng.rand(n).astype(np.float32)
    if "ring" in channels:
        out["ring"] = rng.randint(0, 64, n).astype(np.float32)
    if "time" in channels:
        out["time"] = rng.uniform(0, 0.1, n).astype(np.float32)
    return out


def _both_clouds(arrays, capacity=None):
    return (PointCloud.from_numpy(capacity=capacity, **arrays),
            JPointCloud.from_numpy(capacity=capacity, **arrays))


# ----------------------------------------------------------- text and .bin
def test_native_and_numpy_parsers_agree():
    rng = np.random.RandomState(0)
    data = rng.randn(2000, 4).astype(np.float32) * 50
    text = ("# a header\n" + "\n".join(", ".join(f"{v:.6f}" for v in row) for row in data[:10])
            + "\n" + "\n".join(" ".join(f"{v:.6f}" for v in row) for row in data[10:])).encode()
    by_numpy = native.parse_float_table(text, use_native=False)
    assert by_numpy.shape == (2000, 4)
    np.testing.assert_allclose(by_numpy, data, atol=5e-6)
    if native.available():
        np.testing.assert_array_equal(native.parse_float_table(text), by_numpy)
    assert native.parse_float_table(b"# only comments\n").shape[0] == 0


@pytest.mark.parametrize("name", ["c.xyz", "c.xyz.gz"])
def test_xyz_round_trip_and_across_packages(tmp_path, name):
    arrays = _cloud_arrays(np.random.RandomState(1), 300)
    pc, jpc = _both_clouds(arrays)
    p, jp = str(tmp_path / name), str(tmp_path / f"jax_{name}")
    xyz.save_xyz_file(p, pc)
    jxyz.save_xyz_file(jp, jpc)
    with (gzip.open if name.endswith(".gz") else open)(p, "rb") as f:
        mine = f.read()
    with (gzip.open if name.endswith(".gz") else open)(jp, "rb") as f:
        assert f.read() == mine  # the same text
    back = xyz.load_xyz_file(p)
    np.testing.assert_allclose(back.to_numpy(), arrays["xyz"], atol=5e-7)
    _clouds_equal(back, jxyz.load_xyz_file(p))
    _clouds_equal(xyz.load_xyz_file(jp, decimation=3), jxyz.load_xyz_file(jp, decimation=3))


def test_kitti_bin_round_trip_and_across_packages(tmp_path):
    arrays = _cloud_arrays(np.random.RandomState(2), 500, ("intensity",))
    pc, jpc = _both_clouds(arrays, capacity=1024)
    p, jp = str(tmp_path / "000000.bin"), str(tmp_path / "000001.bin")
    kitti.save_kitti_bin(p, pc)
    jkitti.save_kitti_bin(jp, jpc)
    assert open(p, "rb").read() == open(jp, "rb").read()
    back = kitti.load_kitti_bin(p, capacity=1024)
    _clouds_equal(back, pc)
    _clouds_equal(back, jkitti.load_kitti_bin(p, capacity=1024))
    assert kitti.load_kitti_bin(p).capacity == 512


# --------------------------------------------------------------- .mm.npz
def _npz_maps():
    """(port map, JAX map) of the same contents: point layers with
    channels, a voxel layer, planes, id/label, georeferencing."""
    rng = np.random.RandomState(3)
    a = _cloud_arrays(rng, 100, ("intensity",))
    b = _cloud_arrays(rng, 40, ("intensity", "ring", "time"))
    keys = rng.randint(-50, 50, (16, 3)).astype(np.int32)
    occ = rng.rand(16).astype(np.float32)
    valid = np.arange(16) < 12
    normal = rng.randn(8, 3).astype(np.float32)
    cent = rng.randn(8, 3).astype(np.float32)
    cov = tuple(tuple(float(v) for v in row) for row in np.diag(np.arange(1.0, 7.0)))
    geo = dict(latitude=36.7, longitude=-2.3, height=12.5, t_enu_to_map_xyz=(1.0, 2.0, 3.0),
               t_enu_to_map_quat_wxyz=(1.0, 0.0, 0.0, 0.0), t_enu_to_map_cov=cov)
    t = MetricMap(layers={"raw": PointCloud.from_numpy(**a),
                          "lidar": PointCloud.from_numpy(capacity=64, **b),
                          "vox": VoxelGridLayer(torch.from_numpy(keys), torch.from_numpy(occ),
                                                torch.from_numpy(valid), 0.25)},
                  id=7, label="street", georeferencing=Georeferencing(**geo))
    t.planes = PlaneSet(torch.from_numpy(normal), torch.from_numpy(cent),
                        torch.tensor(5, dtype=torch.int32))
    j = JMetricMap(id=7, label="street", georeferencing=JGeoref(**geo))
    j.layers["raw"] = JPointCloud.from_numpy(**a)
    j.layers["lidar"] = JPointCloud.from_numpy(capacity=64, **b)
    j.layers["vox"] = JVoxels(jnp.asarray(keys), jnp.asarray(occ), jnp.asarray(valid), 0.25)
    j.planes = JPlaneSet(jnp.asarray(normal), jnp.asarray(cent), jnp.asarray(5, jnp.int32))
    return t, j


def test_mm_npz_round_trip_and_across_packages(tmp_path):
    t, j = _npz_maps()
    p, jp = str(tmp_path / "port.mm.npz"), str(tmp_path / "jax.mm.npz")
    mm.save_mm_file(p, t)
    jmm.save_mm_file(jp, j)
    with np.load(p) as a, np.load(jp) as b:  # the same arrays under the same keys
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for path in (p, jp):
        back, jback = mm.load_mm_file(path), jmm.load_mm_file(path)
        _maps_equal(back, t)
        _maps_equal(back, jback)
        np.testing.assert_array_equal(back.planes.centroid.numpy(), _arr(j.planes.centroid))
        assert int(back.planes.count) == 5 and int(back.lines.count) == 0
        assert back.layers["raw"].xyz.device.type == "cpu"


def test_mm_npz_refuses_a_newer_version(tmp_path):
    t, _ = _npz_maps()
    p = str(tmp_path / "m.mm.npz")
    mm.save_mm_file(p, t)
    with np.load(p) as data:
        arrays = dict(data)
    arrays["__meta__"] = np.frombuffer(
        bytes(arrays["__meta__"]).replace(b'"version": 1', b'"version": 9'), dtype=np.uint8)
    np.savez(p, **arrays)
    with pytest.raises(ValueError, match="newer"):
        mm.load_mm_file(p)


# ------------------------------------------------------------ binary .mm
def _mrpt_cases():
    """name -> (port map, JAX map, version) of the writer's cases."""
    rng = np.random.RandomState(4)
    cases = {}

    def both(layers, **kw):
        t = MetricMap(layers={n: PointCloud.from_numpy(**a) for n, a in layers.items()}, **kw)
        j = JMetricMap(**{k: (JGeoref(**dataclasses.asdict(v)) if k == "georeferencing" else v)
                          for k, v in kw.items()})
        for n, a in layers.items():
            j.layers[n] = JPointCloud.from_numpy(**a)
        return t, j

    cases["simple"] = both({"raw": _cloud_arrays(rng, 123)}) + (None,)
    cases["xyzi"] = both({"raw": _cloud_arrays(rng, 77, ("intensity",))}, id=3) + (None,)
    cases["xyzirt"] = both({"lidar": _cloud_arrays(rng, 90, ("intensity", "ring", "time"))},
                           label="scan") + (None,)
    cases["ring only"] = both({"lidar": _cloud_arrays(rng, 33, ("ring",))}) + (None,)
    cov = tuple(tuple(float(v) for v in row) for row in
                np.eye(6) * 0.01 + np.triu(np.full((6, 6), 1e-4), 1) + np.tril(
                    np.full((6, 6), 1e-4), -1))
    geo = Georeferencing(latitude=36.71, longitude=-4.42, height=50.0,
                         t_enu_to_map_xyz=(10.0, -3.0, 0.5),
                         t_enu_to_map_quat_wxyz=(0.9238795325112867, 0.0, 0.0,
                                                 0.3826834323650898),
                         t_enu_to_map_cov=cov)
    cases["georeferenced"] = both({"raw": _cloud_arrays(rng, 20)}, georeferencing=geo) + (None,)
    cases["multi-layer v5"] = both({"a": _cloud_arrays(rng, 10),
                                    "b": _cloud_arrays(rng, 5, ("intensity",)),
                                    "c": _cloud_arrays(rng, 8, ("time",))}, id=11,
                                   label="multi") + (5,)
    t, j = both({"raw": _cloud_arrays(rng, 64)})
    keys = rng.randint(-100, 100, (40, 3)).astype(np.int32)
    occ = np.concatenate([rng.rand(32), np.full(8, 0.5)]).astype(np.float32)
    valid = np.arange(40) < 32
    t.layers["voxels"] = VoxelGridLayer(torch.from_numpy(keys), torch.from_numpy(occ),
                                        torch.from_numpy(valid), 0.25)
    j.layers["voxels"] = JVoxels(jnp.asarray(keys), jnp.asarray(occ), jnp.asarray(valid), 0.25)
    cases["voxel"] = (t, j, None)
    t, j = both({"raw": _cloud_arrays(rng, 12)})
    t.lines_raw = j.lines_raw = rng.randn(3, 6)
    t.planes_raw = j.planes_raw = rng.randn(2, 7)
    cases["raw lines and planes"] = (t, j, None)
    return cases


MRPT_CASES = ("georeferenced", "multi-layer v5", "raw lines and planes", "ring only", "simple",
              "voxel", "xyzi", "xyzirt")


@pytest.mark.parametrize("case", MRPT_CASES)
def test_mrpt_writer_byte_identical_and_readers_equal(tmp_path, case):
    cases = _mrpt_cases()
    assert sorted(cases) == sorted(MRPT_CASES)
    t, j, version = cases[case]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    p, jp = str(tmp_path / "port" / "map.mm"), str(tmp_path / "jax" / "map.mm")
    mrpt_mm.save_mrpt_mm(t, p, version=version)
    jmrpt.save_mrpt_mm(j, jp, version=version)
    assert open(p, "rb").read() == open(jp, "rb").read()
    back, jback = mrpt_mm.load_mrpt_mm(p), jmrpt.load_mrpt_mm(p)
    _maps_equal(back, jback)
    for name, layer in t.layers.items():
        if isinstance(layer, PointCloud):
            n = int(layer.count)
            np.testing.assert_array_equal(back.layers[name].to_numpy(), layer.to_numpy())
            if layer.ring is not None:  # the ring channel travels as u16
                np.testing.assert_array_equal(back.layers[name].ring[:n].numpy(),
                                              layer.ring[:n].numpy())
    # load_mm_file sends a binary archive to the MRPT reader, gzipped or not
    mrpt_mm.save_mrpt_mm(t, p + ".raw", version=version, gzipped=False)
    _maps_equal(mm.load_mm_file(p + ".raw"), back)


def test_mrpt_refusals_and_unknown_layers(tmp_path):
    t, _, _ = _mrpt_cases()["georeferenced"]
    with pytest.raises(ValueError, match="georef"):
        mrpt_mm.save_mrpt_mm(t, str(tmp_path / "g.mm"), version=1)
    with pytest.raises(ValueError, match="covariance layout"):
        mrpt_mm._parse_cov66(mrpt_mm._Reader(np.arange(21, dtype=np.float64).tobytes()))
    # an archive with a layer of an unknown class (decoy end markers in
    # its payload) between two point layers: skipped with a warning
    xyz_ = (np.random.RandomState(5).randn(50, 3) * 5).astype(np.float32)
    for M in (mrpt_mm, jmrpt):
        w = M._Writer()
        w.obj_header("mp2p_icp::metric_map_t", 1)
        w.string("std::vector")
        w.string("TLine3D")
        w.u32(0)
        w.u32(0)
        w.u32(0)
        w.u32(2)
        w.string("voxelmap")
        w.obj_header("mrpt::maps::CVoxelMap", 0)
        w.b += bytes([0x88, 1, 2, 0x88, 3, 4, 5, 6, 7, 8, 9, 10]) * 5
        w.end()
        w.string("raw")
        cloud = (PointCloud if M is mrpt_mm else JPointCloud).from_numpy(xyz_)
        M._write_point_layer(w, cloud)
        for tname in ("uint64_t", "std::string"):
            w.string("std::optional")
            w.string(tname)
            w.boolean(False)
        w.end()
        p = str(tmp_path / f"mixed_{M.__name__.split('.')[0]}.mm")
        with open(p, "wb") as f:
            f.write(gzip.compress(bytes(w.b)))
        with pytest.warns(UserWarning, match="CVoxelMap"):
            got = mrpt_mm.load_mrpt_mm(p)
        assert list(got.layers) == ["raw"]
        np.testing.assert_array_equal(got.layers["raw"].to_numpy(), xyz_)
        with pytest.raises(ValueError, match="unsupported class"):
            mrpt_mm.load_mrpt_mm(p, strict=True)


# ----------------------------------------------------------------- rawlog
def _rawlog_obs(rng, pose_of):
    return [
        dict(class_name="CObservationPointCloud", sensor_label="lidar", timestamp=1.5,
             xyz=rng.uniform(-10, 10, (50, 3)).astype(np.float32),
             intensity=rng.rand(50).astype(np.float32),
             sensor_pose=pose_of(0.1, 0.0, 0.5, 0.2, 0.0, 0.0)),
        dict(class_name="CObservationIMU", sensor_label="imu", timestamp=1.6,
             angular_velocity=(0.0, 0.0, 0.3)),
        dict(class_name="CObservationComment", timestamp=1.7,
             text="local_velocity_buffer:\n  entries: []"),
    ]


def test_rawlog_round_trip_and_across_packages(tmp_path):
    rl = rawlog.Rawlog()
    for i, o in enumerate(_rawlog_obs(np.random.RandomState(6), se3.from_xyz_ypr)):
        rl.append(Observation(**o), frame=None if i == 0 else 4)
    jrl = jrawlog.Rawlog()
    for i, o in enumerate(_rawlog_obs(np.random.RandomState(6), jse3.from_xyz_ypr)):
        jrl.append(JObservation(**o), frame=None if i == 0 else 4)
    p, jp = str(tmp_path / "port.rawlog.npz"), str(tmp_path / "jax.rawlog.npz")
    rl.save(p)
    jrl.save(jp)
    with np.load(p) as a, np.load(jp) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for path in (p, jp):
        back, jback = rawlog.Rawlog.load(path), jrawlog.Rawlog.load(path)
        assert back.frames == jback.frames == [0, 4, 4]
        for o, jo in zip(back.observations, jback.observations):
            for f in ("class_name", "sensor_label", "timestamp", "text", "angular_velocity"):
                assert getattr(o, f) == getattr(jo, f), f
            for ch in ("xyz", "intensity"):
                a, b = getattr(o, ch), getattr(jo, ch)
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_array_equal(a, b)
            assert (o.sensor_pose is None) == (jo.sensor_pose is None)
            if o.sensor_pose is not None:
                np.testing.assert_array_equal(o.sensor_pose.R.numpy(),
                                              np.asarray(jo.sensor_pose.R))


def test_pointcloud_to_observation_trims_the_padding():
    arrays = _cloud_arrays(np.random.RandomState(7), 10, ("intensity", "ring"))
    pc, jpc = _both_clouds(arrays, capacity=256)
    obs = rawlog.pointcloud_to_observation(pc, sensor_label="out_raw", timestamp=2.0)
    jobs = jrawlog.pointcloud_to_observation(jpc, sensor_label="out_raw", timestamp=2.0)
    assert obs.xyz.shape == (10, 3) and obs.time is None
    for ch in ("xyz", "intensity", "ring"):
        np.testing.assert_array_equal(getattr(obs, ch), getattr(jobs, ch))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        LineSet.empty()  # the empty sets construct on the requested device
