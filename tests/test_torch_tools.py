"""The port's map tools against the JAX package's, on the CPU.

Mirrors tests/test_geodesy.py, tests/test_io_apps.py (the converters),
tests/test_apps2.py (mm-georef, the viewers, sm-filter), tests/test_rawlog.py
and tests/test_html_viewer.py. The same numpy inputs or the same files go
through both packages:

- core/geodesy.py: equal to the bit, on every case of tests/test_geodesy.py
  (and its published WGS-84 values);
- utils/profiler.py: report() equal to JAX's text for the same spans (the
  host clock patched), a span named in a torch.profiler trace;
- txt2mm, mm2txt, kitti2mm, mm-info: the files across packages equal, the
  printed lines equal;
- mm-georef: the five modes' printed lines equal, --to-enu's rows equal;
- mm-viewer, icp-log-viewer: the text equal, the HTML byte for byte JAX's,
  the PNGs written;
- rawlog-filter and sm-filter at 16 x 512 rays of the street drive (the
  chip's pipeline, chip_smoke.TOOLS_YAML: range, FirstPoint 0.5 m, normals
  k=8): every output observation's rows and sums equal, the normals within
  chip_smoke.NORMALS_BAND but for at most NORMALS_SHARE of the rows; --from /
  --to and an unhandled observation.
"""

import contextlib
import io
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import mp2p_icp_tpu_torch
from mp2p_icp_tpu.apps import html_viewer as jhtml
from mp2p_icp_tpu.core import geodesy as jgeo
from mp2p_icp_tpu.core.metric_map import Georeferencing as JGeoref
from mp2p_icp_tpu.core.metric_map import MetricMap as JMetricMap
from mp2p_icp_tpu.core.metric_map import VoxelGridLayer as JVoxelGridLayer
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.io.mm import load_mm_file as jload_mm
from mp2p_icp_tpu.io.mm import save_mm_file as jsave_mm
from mp2p_icp_tpu.io.rawlog import Rawlog as JRawlog
from mp2p_icp_tpu_torch.apps import html_viewer
from mp2p_icp_tpu_torch.core import geodesy
from mp2p_icp_tpu_torch.core.metric_map import Georeferencing
from mp2p_icp_tpu_torch.io.mm import load_mm_file
from mp2p_icp_tpu_torch.io.rawlog import Rawlog
from mp2p_icp_tpu_torch.utils import Profiler, profile_scope

RINGS, AZIMUTHS, FRAMES = 16, 512, 4


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _printed(main, argv, rc=0):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main([str(a) for a in argv]) == rc
    return buf.getvalue()


def _apps(name):
    """(the port's app module, the JAX package's) of one app."""
    import importlib

    return (importlib.import_module(f"mp2p_icp_tpu_torch.apps.{name}"),
            importlib.import_module(f"mp2p_icp_tpu.apps.{name}"))


# ------------------------------------------------------------------ geodesy
def _yawed(deg, xyz=(10.0, -5.0, 2.0), lat=40.0, lon=-3.0, h=650.0, cls=Georeferencing):
    ang = np.deg2rad(deg)
    return cls(latitude=lat, longitude=lon, height=h, t_enu_to_map_xyz=xyz,
               t_enu_to_map_quat_wxyz=(np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)))


def _map_round_trip(g, cls):
    georef = _yawed(30.0, cls=cls)
    pts = np.random.RandomState(2).uniform(-500, 500, (10, 3))
    lat, lon, h = g.map_to_geodetic(pts, georef)
    return np.stack([g.geodetic_to_map(a, b, c, georef) for a, b, c in zip(lat, lon, h)])


_RNG_LAT = np.random.RandomState(0)
_LLH = (_RNG_LAT.uniform(-85, 85, 50), _RNG_LAT.uniform(-180, 180, 50),
        _RNG_LAT.uniform(-100, 5000, 50))
_ENU = np.random.RandomState(1).uniform(-2000, 2000, (20, 3))

# every case of tests/test_geodesy.py: (call on a geodesy module and a
# Georeferencing class, the published value or None)
GEODESY_CASES = {
    "equator_prime_meridian": (lambda g, G: g.geodetic_to_ecef(0.0, 0.0, 0.0),
                               [6378137.0, 0.0, 0.0]),
    "north_pole": (lambda g, G: g.geodetic_to_ecef(90.0, 0.0, 0.0), [0.0, 0.0, 6356752.31424518]),
    "equator_90E_with_height": (lambda g, G: g.geodetic_to_ecef(0.0, 90.0, 100.0),
                                [0.0, 6378137.0 + 100.0, 0.0]),
    "ecef_round_trip": (lambda g, G: np.stack(g.ecef_to_geodetic(g.geodetic_to_ecef(*_LLH))),
                        np.stack(_LLH)),
    "anchor_is_origin": (lambda g, G: g.geodetic_to_enu(45.0, 7.0, 500.0, 45.0, 7.0, 500.0),
                         [0.0, 0.0, 0.0]),
    "up_axis": (lambda g, G: g.geodetic_to_enu(45.0, 7.0, 550.0, 45.0, 7.0, 500.0),
                [0.0, 0.0, 50.0]),
    "east_axis": (lambda g, G: g.geodetic_to_enu(0.0, 1e-3, 0.0, 0.0, 0.0, 0.0), None),
    "north_axis": (lambda g, G: g.geodetic_to_enu(1e-3, 0.0, 0.0, 0.0, 0.0, 0.0), None),
    "enu_round_trip": (lambda g, G: g.geodetic_to_enu(
        *g.enu_to_geodetic(_ENU, 48.2, 16.4, 170.0), 48.2, 16.4, 170.0), _ENU),
    "map_round_trip": (_map_round_trip, np.random.RandomState(2).uniform(-500, 500, (10, 3))),
    "enu_map_quaternion": (lambda g, G: g.enu_to_map(
        np.array([1.0, 0.0, 0.0]), _yawed(30.0, (1.0, 2.0, 3.0), cls=G)),
        [1.0 + np.cos(np.pi / 6), 2.0 + np.sin(np.pi / 6), 3.0]),
}


@pytest.mark.parametrize("case", sorted(GEODESY_CASES))
def test_geodesy_equals_jax_to_the_bit(case):
    fn, published = GEODESY_CASES[case]
    got, want = np.asarray(fn(geodesy, Georeferencing)), np.asarray(fn(jgeo, JGeoref))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    if published is not None:
        np.testing.assert_allclose(got, published, atol=1e-6)
    if case == "east_axis":  # +1e-3 deg of longitude at the equator ~ 111.319 m east
        assert got[0] == pytest.approx(111.3194, abs=0.01) and abs(got[1]) < 1e-3
    if case == "north_axis":  # ... of latitude ~ 110.574 m north
        assert got[1] == pytest.approx(110.5743, abs=0.01) and abs(got[0]) < 1e-3


# ----------------------------------------------------------------- profiler
def test_profiler_report_equals_jax(monkeypatch):
    """The same spans (nested names, repeated calls) under a patched host
    clock: stats() and report() equal the JAX package's."""
    from mp2p_icp_tpu.utils import profiler as jprofiler

    ticks = np.cumsum(np.arange(1, 200) * 1.25e-3).tolist()
    # the JAX package's device annotation would start jax's profiler
    monkeypatch.setattr(jprofiler, "profile_scope", lambda name: contextlib.nullcontext())
    reports = []
    for cls in (Profiler, jprofiler.Profiler):
        clock = iter(ticks)
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        prof = cls()
        for i in range(3):
            with prof.scope("align"):
                with prof.scope("align.1_prepare"):
                    pass
                for _ in range(i + 1):
                    with prof.scope("align.3.1_matchers"):
                        pass
        with cls(enabled=False).scope("off"):
            pass
        reports.append((prof.stats(), prof.report()))
    assert reports[0] == reports[1]
    assert reports[0][1].splitlines()[1].startswith("align ")
    assert reports[0][0]["align.3.1_matchers"]["calls"] == 6


def test_profile_scope_names_a_torch_profiler_range():
    """A Profiler span is a record_function range: its name appears among
    the events of a torch.profiler trace around it."""
    prof = Profiler()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as trace:
        with prof.scope("tools.rawlog_filter"):
            torch.ones(8).sum()
        with profile_scope("tools.bare_scope"):
            torch.zeros(8).sum()
    names = {e.name for e in trace.events()}
    assert {"tools.rawlog_filter", "tools.bare_scope"} <= names
    assert prof.stats()["tools.rawlog_filter"]["calls"] == 1


# --------------------------------------------------------------- converters
@pytest.fixture(scope="module")
def street(tmp_path_factory, _ask_for_the_cpu):
    """FRAMES frames of the street drive at RINGS x AZIMUTHS, frame 0 as
    .txt and KITTI .bin, all of them as a .rawlog.npz (and one with an IMU
    observation first)."""
    root = tmp_path_factory.mktemp("tools")
    _, _, scans = cs.make_street_sequence(FRAMES, n_rings=RINGS, n_azimuth=AZIMUTHS)
    txt, bin_ = cs.tools_inputs_frame0(scans[0], root)
    pipeline = root / "tools.yaml"
    pipeline.write_text(cs.TOOLS_YAML)
    return {"root": root, "scans": scans, "txt": txt, "bin": bin_, "pipeline": pipeline,
            "rawlog": cs.write_rawlog(root / "in.rawlog.npz", scans),
            "rawlog_imu": cs.write_rawlog(root / "imu.rawlog.npz", scans, imu_first=True)}


def _maps_equal(a, b):
    """Two .mm.npz maps (read by the JAX package) layer for layer."""
    assert sorted(a.layers) == sorted(b.layers) and (a.id, a.label) == (b.id, b.label)
    for name in a.layers:
        x, y = a.layers[name], b.layers[name]
        fields = (("xyz", "count", "intensity", "ring", "time") if hasattr(x, "xyz")
                  else ("keys", "occupancy", "valid"))
        for f in fields:
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None), f
            if u is not None:
                np.testing.assert_array_equal(np.asarray(u), np.asarray(v), err_msg=f)


@pytest.mark.parametrize("fmt", ["xyz", "xyzi", "xyzirt", "xyzrgb"])
def test_txt2mm_and_mm2txt_equal_jax(street, tmp_path, monkeypatch, fmt):
    """txt2mm: the same map file (read back by both packages), the same
    line; mm2txt of it: the same text file; the round trip returns the
    input's columns."""
    port, jax_app = _apps("txt2mm")
    argv = ["-i", street["txt"], "-f", fmt, "--label", "frame0", "--id", 7]
    text = _printed(port.main, argv + ["-o", tmp_path / "port.mm.npz"])
    jtext = _printed(jax_app.main, argv + ["-o", tmp_path / "jax.mm.npz"])
    assert text.replace("port.mm", "jax.mm") == jtext
    _maps_equal(jload_mm(str(tmp_path / "port.mm.npz")), jload_mm(str(tmp_path / "jax.mm.npz")))
    mine = load_mm_file(str(tmp_path / "port.mm.npz"))
    assert mine.layers["raw"].xyz.device.type == "cpu"

    port2, jax2 = _apps("mm2txt")
    monkeypatch.chdir(tmp_path)
    out = _printed(port2.main, [tmp_path / "port.mm.npz"])
    jout = _printed(jax2.main, [tmp_path / "jax.mm.npz"])
    assert out.replace("port_", "jax_") == jout
    got = (tmp_path / "port_raw.txt").read_bytes()
    assert got == (tmp_path / "jax_raw.txt").read_bytes()
    data = np.loadtxt(street["txt"], dtype=np.float32)
    back = np.loadtxt(tmp_path / "port_raw.txt", dtype=np.float32)
    cols = {"xyz": 3, "xyzi": 4, "xyzirt": 6, "xyzrgb": 3}[fmt]
    np.testing.assert_array_equal(back[:, :cols], data[:, :cols])


def test_kitti2mm_and_mm_info_equal_jax(street, tmp_path):
    port, jax_app = _apps("kitti2mm")
    argv = ["-i", street["bin"], "--layer", "scan"]
    text = _printed(port.main, argv + ["-o", tmp_path / "port.mm.npz"])
    jtext = _printed(jax_app.main, argv + ["-o", tmp_path / "jax.mm.npz"])
    assert text.replace("port.mm", "jax.mm") == jtext
    _maps_equal(jload_mm(str(tmp_path / "port.mm.npz")), jload_mm(str(tmp_path / "jax.mm.npz")))
    rows = np.fromfile(street["bin"], np.float32).reshape(-1, 4)
    layer = load_mm_file(str(tmp_path / "port.mm.npz")).layers["scan"]
    np.testing.assert_array_equal(layer.to_numpy(), rows[:, :3])
    np.testing.assert_array_equal(layer.intensity[: len(rows)].numpy(), rows[:, 3])
    port_info, jax_info = _apps("mm_info")
    line = _printed(port_info.main, [tmp_path / "port.mm.npz"])
    assert line == _printed(jax_info.main, [tmp_path / "port.mm.npz"])
    assert line == f"layer 'scan': {len(rows)} points (capacity {layer.capacity})\n"


# ---------------------------------------------------------------- mm-georef
@pytest.fixture(scope="module")
def georef_map(tmp_path_factory, _ask_for_the_cpu):
    """A map of a point layer (beyond its count, padding), a voxel layer and
    chip_smoke.GEOREF's georeferencing, written by the JAX package; the
    same map without a georeferencing; the georeferencing's YAML."""
    import yaml

    root = tmp_path_factory.mktemp("georef")
    rng = np.random.RandomState(3)
    pts = rng.uniform(-80, 80, (700, 3)).astype(np.float32)
    vg = JVoxelGridLayer(keys=jnp.asarray(rng.randint(-50, 50, (64, 3)).astype(np.int32)),
                         occupancy=jnp.asarray(rng.rand(64).astype(np.float32)),
                         valid=jnp.asarray(np.arange(64) < 40), resolution=0.5)
    mm = JMetricMap(layers={"raw": JPointCloud.from_numpy(pts, capacity=1024), "vox": vg})
    jsave_mm(str(root / "plain.mm.npz"), mm)
    (root / "georef.yaml").write_text(yaml.safe_dump({"georeferencing": cs.GEOREF}))
    t = cs.GEOREF["t_enu_to_map"]
    mm.georeferencing = JGeoref(
        latitude=cs.GEOREF["latitude"], longitude=cs.GEOREF["longitude"],
        height=cs.GEOREF["height"], t_enu_to_map_xyz=tuple(t["translation"]),
        t_enu_to_map_quat_wxyz=tuple(t["quaternion_wxyz"]))
    jsave_mm(str(root / "geo.mm.npz"), mm)
    return root


@pytest.mark.parametrize("mode", ["print", "no_georef", "extract", "inject", "geodetic_to_map",
                                  "map_to_geodetic", "to_enu"])
def test_mm_georef_equals_jax(georef_map, tmp_path, mode):
    port, jax_app = _apps("mm_georef")
    root = georef_map
    src = root / ("plain.mm.npz" if mode in ("no_georef", "inject") else "geo.mm.npz")
    extra = {"print": [], "no_georef": ["--geodetic-to-map", cs.GEOREF_FIX],
             "extract": ["--extract", "{out}.yaml"],
             "inject": ["--inject", root / "georef.yaml", "-o", "{out}.mm.npz"],
             "geodetic_to_map": ["--geodetic-to-map", cs.GEOREF_FIX],
             "map_to_geodetic": ["--map-to-geodetic", cs.GEOREF_POINT],
             "to_enu": ["--to-enu", "-o", "{out}.mm.npz"]}[mode]
    outs = {}
    for who, app in (("port", port), ("jax", jax_app)):
        stem = str(tmp_path / who)
        argv = [src] + [str(a).replace("{out}", stem) for a in extra]
        outs[who] = _printed(app.main, argv, rc=1 if mode == "no_georef" else 0).replace(
            stem, "OUT")
    assert outs["port"] == outs["jax"]
    if mode == "extract":
        assert (tmp_path / "port.yaml").read_text() == (tmp_path / "jax.yaml").read_text()
    if mode in ("inject", "to_enu"):
        a, b = jload_mm(str(tmp_path / "port.mm.npz")), jload_mm(str(tmp_path / "jax.mm.npz"))
        _maps_equal(a, b)
        assert a.georeferencing == b.georeferencing
    if mode == "inject":  # and extracted again: the same YAML as the input's
        _printed(port.main, [tmp_path / "port.mm.npz", "--extract", tmp_path / "again.yaml"])
        import yaml

        assert yaml.safe_load((tmp_path / "again.yaml").read_text()) == {
            "georeferencing": cs.GEOREF}
    if mode == "to_enu":  # the padding rows stay at the sentinel
        xyz = np.asarray(jload_mm(str(tmp_path / "port.mm.npz")).layers["raw"].xyz)
        assert (xyz[700:] == 1.0e8).all()


# ------------------------------------------------------------------ viewers
@pytest.fixture(scope="module")
def icp_log(tmp_path_factory, _ask_for_the_cpu):
    """An .icplog.npz with iterations and pairings recorded (the JAX
    package's run, as tests/test_html_viewer.py makes it)."""
    from mp2p_icp_tpu.core import se3 as jse3
    from mp2p_icp_tpu.icp import ICP, ICPParameters
    from mp2p_icp_tpu.io.icplog import save_log
    from mp2p_icp_tpu.matchers import MatcherPointsDistanceThreshold
    from mp2p_icp_tpu.solvers.solver import SolverHorn

    rng = np.random.RandomState(1)
    xyz = rng.uniform(-8, 8, (400, 3)).astype(np.float32)
    gt = jse3.from_xyz_ypr(0.3, -0.2, 0.1, 0.04, -0.02, 0.01)
    local = np.array(jse3.apply(jse3.inverse(gt), jnp.asarray(xyz)))
    g, loc = {"raw": JPointCloud.from_numpy(xyz)}, {"raw": JPointCloud.from_numpy(local)}
    icp = ICP(matchers=[MatcherPointsDistanceThreshold(threshold=1.2)], solvers=[SolverHorn()])
    res = icp.align(loc, g, jse3.identity(),
                    ICPParameters(max_iterations=10, record_iterations=True,
                                  record_pairings=True))
    path = tmp_path_factory.mktemp("log") / "run.icplog.npz"
    save_log(str(path), loc, g, jse3.identity(), res)
    return path


@pytest.mark.parametrize("traj", [None, "kitti", "tum"])
def test_mm_viewer_text_and_html_equal_jax(georef_map, tmp_path, traj):
    port, jax_app = _apps("mm_viewer")
    extra = []
    if traj:
        rng = np.random.RandomState(4)
        rows = (np.tile(np.eye(4)[:3].reshape(-1), (6, 1)) if traj == "kitti"
                else np.column_stack([np.arange(6.0), rng.uniform(-5, 5, (6, 3)),
                                      np.tile([0.0, 0.0, 0.0, 1.0], (6, 1))]))
        rows[:, 3 if traj == "kitti" else 1] += np.arange(6)
        np.savetxt(tmp_path / "traj.txt", rows)
        extra = ["--trajectory", tmp_path / "traj.txt"]
    src = georef_map / "geo.mm.npz"
    text = _printed(port.main, [src, "--html", tmp_path / "port.html"] + extra)
    jtext = _printed(jax_app.main, [src, "--html", tmp_path / "jax.html"] + extra)
    assert text.replace("port.html", "jax.html") == jtext
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "jax.html").read_bytes()


def test_icp_log_viewer_text_and_html_equal_jax(icp_log, tmp_path):
    port, jax_app = _apps("icp_log_viewer")
    text = _printed(port.main, [icp_log, "--html", tmp_path / "port.html"])
    jtext = _printed(jax_app.main, [icp_log, "--html", tmp_path / "jax.html"])
    assert text.replace("port.html", "jax.html") == jtext
    assert "d_mean=" in text and text.count("    it ") == 10
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "jax.html").read_bytes()


def test_html_exports_equal_jax(tmp_path):
    """export_map_html of a map with intensities, a voxel layer and a
    trajectory, decimated to a smaller max_points_per_layer: the same file."""
    from mp2p_icp_tpu_torch.core.metric_map import MetricMap, VoxelGridLayer
    from mp2p_icp_tpu_torch.core.pointcloud import PointCloud

    rng = np.random.RandomState(0)
    xyz = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    inten = rng.rand(500).astype(np.float32)
    keys = rng.randint(-50, 50, (64, 3)).astype(np.int32)
    occ = rng.rand(64).astype(np.float32)
    valid = np.arange(64) < 40
    traj = rng.uniform(-5, 5, (20, 3)).astype(np.float32)
    mt = MetricMap(layers={"raw": PointCloud.from_numpy(xyz, intensity=inten),
                           "vox": VoxelGridLayer(torch.from_numpy(keys), torch.from_numpy(occ),
                                                 torch.from_numpy(valid), 0.5)})
    mj = JMetricMap(layers={"raw": JPointCloud.from_numpy(xyz, intensity=inten),
                            "vox": JVoxelGridLayer(jnp.asarray(keys), jnp.asarray(occ),
                                                   jnp.asarray(valid), 0.5)})
    html_viewer.export_map_html(mt, str(tmp_path / "port.html"), max_points_per_layer=120,
                                trajectory=torch.from_numpy(traj))
    jhtml.export_map_html(mj, str(tmp_path / "jax.html"), max_points_per_layer=120,
                          trajectory=traj)
    assert (tmp_path / "port.html").read_bytes() == (tmp_path / "jax.html").read_bytes()
    assert html_viewer._JS == jhtml._JS and html_viewer._HTML == jhtml._HTML
    assert html_viewer._PALETTE == jhtml._PALETTE


def test_viewers_write_pngs(georef_map, icp_log, tmp_path):
    """-o renders: mm-viewer a PNG per layer (points, voxels) with a
    trajectory, icp-log-viewer the overlay and an iteration's pairings
    (matplotlib is imported only here)."""
    mm_viewer, _ = _apps("mm_viewer")
    log_viewer, _ = _apps("icp_log_viewer")
    np.savetxt(tmp_path / "traj.txt", np.tile(np.eye(4)[:3].reshape(-1), (3, 1)))
    text = _printed(mm_viewer.main, [georef_map / "geo.mm.npz", "-o", tmp_path / "map",
                                     "--trajectory", tmp_path / "traj.txt"])
    assert "wrote" in text and (tmp_path / "map_raw.png").stat().st_size > 1000
    assert (tmp_path / "map_vox.png").stat().st_size > 1000
    text = _printed(log_viewer.main, [icp_log, "-o", tmp_path / "log", "-i", 3])
    assert "overlay" in text and (tmp_path / "log_overlay.png").stat().st_size > 1000
    assert (tmp_path / "log_iter003.png").stat().st_size > 1000


# ------------------------------------------------------ rawlog-filter, sm-filter
def _run_filter_app(name, argv, capture):
    """The port's and the JAX package's app on the same argv (OUT replaced
    by each one's output), each fitted decimated layer captured."""
    import mp2p_icp_tpu.filters as jfilters
    import mp2p_icp_tpu_torch.filters as tfilters

    port, jax_app = _apps(name)
    got = {}
    for who, app, mod in (("port", port, tfilters), ("jax", jax_app, jfilters)):
        record = []
        with cs.captured_layers(mod, record):
            text = _printed(app.main, [str(a).replace("OUT", f"{who}_out") for a in argv])
            got[who] = (text.replace(f"{who}_out", "OUT"), record)
    return got


def _normals_held(port_layers, jax_layers):
    """Each fitted layer: the same rows; the normals within NORMALS_BAND
    but for at most NORMALS_SHARE of the rows. Returns the rows beyond."""
    beyond = 0
    assert len(port_layers) == len(jax_layers) > 0
    for a, b in zip(port_layers, jax_layers):
        n = int(a["count"])
        assert n == int(b["count"]) > 0
        np.testing.assert_array_equal(a["xyz"][:n], b["xyz"][:n])
        far = cs.normals_beyond_band(a["normals"][:n], b["normals"][:n].astype(np.float64))
        assert far.mean() <= cs.NORMALS_SHARE, far.mean()
        beyond += int(far.sum())
        sa, sb = cs.normals_summary(a), cs.normals_summary(b)
        assert abs(sa["with_normal"] - sb["with_normal"]) <= far.sum()
    return beyond


def test_rawlog_filter_equals_jax(street, tmp_path):
    """The chip's pipeline over the street frames: per frame the original
    observation and out_<layer> of each point layer in sorted order, each
    as JAX's (rows exact, sums), the normals its run fitted held to JAX's."""
    root = street["root"]
    got = _run_filter_app("rawlog_filter", ["-i", street["rawlog"], "-o", tmp_path / "OUT.npz",
                                            "-p", street["pipeline"]], None)
    ja, pa = JRawlog.load(str(tmp_path / "jax_out.npz")), Rawlog.load(str(tmp_path / "port_out.npz"))
    mine, ref = cs.rawlog_summary(pa), cs.rawlog_summary(ja)
    assert len(mine) == FRAMES and mine == ref
    assert [o["label"] for o in mine[0]] == ["lidar", "out_decimated", "out_ranged", "out_raw"]
    assert pa.frames == ja.frames == [f for f in range(FRAMES) for _ in range(4)]
    for a, b in zip(pa.observations, ja.observations):
        for ch in ("xyz", "intensity", "ring", "time"):
            np.testing.assert_array_equal(getattr(a, ch), getattr(b, ch))
    text, jtext = got["port"][0], got["jax"][0]
    # the same lines but for the progress line's ETA
    assert [x for x in text.splitlines() if "ETA" not in x] == [
        x for x in jtext.splitlines() if "ETA" not in x]
    _normals_held(got["port"][1], got["jax"][1])
    assert root.exists()


@pytest.mark.parametrize("window", [("0", "2"), ("2", None), ("1", "99")])
def test_rawlog_filter_window_and_unhandled_equal_jax(street, tmp_path, window):
    """--from / --to over a stream whose first entry is an IMU observation
    (no generator handles it: skipped), with an empty filter list."""
    (tmp_path / "p.yaml").write_text("filters: []\n")
    argv = ["-i", street["rawlog_imu"], "-o", tmp_path / "OUT.npz", "-p", tmp_path / "p.yaml",
            "--from", window[0], "-v", "QUIET"] + (["--to", window[1]] if window[1] else [])
    _run_filter_app("rawlog_filter", argv, None)
    ja, pa = JRawlog.load(str(tmp_path / "jax_out.npz")), Rawlog.load(str(tmp_path / "port_out.npz"))
    assert cs.rawlog_summary(pa) == cs.rawlog_summary(ja)
    assert pa.frames == ja.frames
    first = int(window[0])
    last = min(FRAMES, int(window[1]) if window[1] else FRAMES)
    assert len(pa) == 2 * (last - max(first, 1) + 1)


def test_sm_filter_equals_jax(tmp_path):
    """sm-filter with the chip's pipeline over a 3-keyframe simple map of
    the street drive (as the sm2mm phase builds it, with a moving box):
    keyframe by keyframe the same decimated rows, the printed line, the
    normals held."""
    from mp2p_icp_tpu.filters.sm2mm import SimpleMap as JSimpleMap
    from mp2p_icp_tpu_torch.filters.sm2mm import SimpleMap

    gt, tw, scans = cs.make_street_sequence(3, n_rings=RINGS, n_azimuth=AZIMUTHS)
    sm, _ = cs.sm2mm_build(cs.sm2mm_inputs(gt, tw, scans, n_keyframes=3), precise=False)
    sm.save(str(tmp_path / "in.sm.npz"))
    (tmp_path / "p.yaml").write_text(cs.TOOLS_YAML)
    got = _run_filter_app("sm_filter", ["-i", tmp_path / "in.sm.npz", "-o", tmp_path / "OUT.sm.npz",
                                        "-p", tmp_path / "p.yaml", "--output-layer",
                                        cs.TOOLS_LAYER], None)
    assert got["port"][0] == got["jax"][0]
    a, b = SimpleMap.load(str(tmp_path / "port_out.sm.npz")), JSimpleMap.load(
        str(tmp_path / "jax_out.sm.npz"))
    assert cs.simplemap_summary(a) == cs.simplemap_summary(b)
    assert cs.simplemap_summary(a) != cs.simplemap_summary(sm)  # decimated
    for ka, kb in zip(a.keyframes, b.keyframes):
        for oa, ob in zip(ka.observations, kb.observations):
            for ch in ("xyz", "intensity", "ring", "time"):
                np.testing.assert_array_equal(getattr(oa, ch), getattr(ob, ch))
    _normals_held(got["port"][1], got["jax"][1])
