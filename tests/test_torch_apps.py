"""The port's command-line entry points against the JAX package's, on the CPU.

Mirrors tests/test_io_apps.py, tests/test_apps2.py,
tests/test_odometry_mapping.py::TestMappingCLI and tests/test_sequence.py on
generated inputs (two frames of the street drive at 16 rings x 256
azimuths, chip_smoke.write_apps_sequence, as .xyz.gz, MRPT .mm and .mm.npz,
chip_smoke.write_app_inputs), each app run through both packages'
``main``:

- kitti-odometry: tests/test_torch_kitti_odometry.py;
- icp-run from both formats: the printed results as JAX's (pose within
  5e-3, same termination, iterations +-1), the --out-log files equal;
- mm-filter with the structured filters: every output layer row for row,
  FilterEdgesPlanes' rows only on threshold voxels;
- sm2mm on a small simple map: the same map;
- sm-cli: every command's printed lines and files as JAX's.
"""

import contextlib
import io

import numpy as np
import pytest
import torch
import yaml

import chip_smoke as cs
import mp2p_icp_tpu_torch
from mp2p_icp_tpu.apps import icp_run as jicp_run
from mp2p_icp_tpu.apps import mm_filter as jmm_filter
from mp2p_icp_tpu.apps import sm2mm_app as jsm2mm_app
from mp2p_icp_tpu.apps import sm_cli as jsm_cli
from mp2p_icp_tpu.filters.sm2mm import SimpleMap as JSimpleMap
from mp2p_icp_tpu.io.icplog import load_log as jload_log
from mp2p_icp_tpu.io.mm import load_mm_file as jload_mm_file
from mp2p_icp_tpu_torch.apps import icp_run, mm_filter, sm2mm_app, sm_cli
from mp2p_icp_tpu_torch.filters import FilterEdgesPlanes
from mp2p_icp_tpu_torch.filters.sm2mm import SimpleMap
from mp2p_icp_tpu_torch.io.icplog import load_log
from mp2p_icp_tpu_torch.io.mm import load_mm_file

FRAMES, RINGS, AZIMUTHS = 2, 16, 256
KITTI = str(cs.KITTI_YAML)


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _printed(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main([str(a) for a in argv]) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory, _ask_for_the_cpu):
    root = tmp_path_factory.mktemp("apps")
    bin_dir, gt_path, scans = cs.write_apps_sequence(root / "sequence", FRAMES, RINGS, AZIMUTHS)
    files = cs.write_app_inputs(root / "inputs", scans)
    return {"root": root, "bin_dir": bin_dir, "gt": gt_path, "files": files}


# ------------------------------------------------------------------ icp-run
@pytest.mark.parametrize("fmt", ["xyz", "mm"])
def test_icp_run_matches_jax(inputs, fmt):
    files, root = inputs["files"], inputs["root"]
    argv = ["--input-local", files[f"{fmt}1"], "--input-global", files[f"{fmt}0"], "-c", KITTI,
            "--guess", "0.1 0 0 0 0 0"]
    text = _printed(icp_run.main, argv + ["--out-log", root / f"port_{fmt}.icplog.npz"])
    jtext = _printed(jicp_run.main, argv + ["--out-log", root / f"jax_{fmt}.icplog.npz"])
    got, ref = cs.icp_run_printed(text), cs.icp_run_printed(jtext)
    dev = torch.device("cpu")
    gap = float(cs.se3.error_log_norm(cs.pose_of_printed(ref, dev), cs.pose_of_printed(got, dev)))
    assert gap < 5e-3
    assert got["termination"] == ref["termination"]
    assert cs.iterations_agree(got["iterations"], ref["iterations"])
    log = load_log(str(root / f"port_{fmt}.icplog.npz"))
    jlog = jload_log(str(root / f"port_{fmt}.icplog.npz"))  # the JAX package reads it
    assert log["meta"]["n_iterations"] == got["iterations"] == jlog["meta"]["n_iterations"]
    np.testing.assert_array_equal(log["result"].t.numpy(), np.asarray(jlog["result"].t))
    assert sorted(log["local"]) == sorted(jlog["local"]) == ["decimated", "raw"]


def test_icp_run_profiler_reports_the_aligns_spans(inputs):
    """--profiler prints the installed Profiler's report of the align's
    spans (the reference's CTimeLogger dump): one icp.iter a iteration."""
    files = inputs["files"]
    text = _printed(icp_run.main, ["--input-local", files["xyz1"], "--input-global",
                                   files["xyz0"], "-c", KITTI, "--profiler"])
    got = cs.icp_run_printed(text)
    rows = {line.split()[0]: line.split()[1:] for line in text.splitlines()[1:]
            if line.split() and line.split()[0].startswith("icp.")}
    assert {"icp.align", "icp.iter", "icp.match", "icp.solve"} <= set(rows)
    assert int(rows["icp.align"][0]) == 1
    assert int(rows["icp.iter"][0]) == int(rows["icp.match"][0]) == got["iterations"]
    assert "align time" in text


def test_icp_run_filter_sections_and_debug_log(inputs, tmp_path, monkeypatch):
    """A separate filters file for the local side, the global side's
    section by name, and -d: the same printed results as JAX's, and the
    debug file written."""
    files = inputs["files"]
    local = tmp_path / "local.yaml"
    local.write_text(yaml.safe_dump({"filters": [{
        "class_name": "mp2p_icp_filters::FilterDecimateVoxels",
        "params": {"output_pointcloud_layer": "decimated", "voxel_filter_resolution": 1.5}}]}))
    argv = ["--input-local", files["xyz1"], "--input-global", files["xyz0"], "-c", KITTI,
            "--config-filters-local", local, "--entry-name-filters-global", "filters", "-d"]
    monkeypatch.chdir(tmp_path)
    got = cs.icp_run_printed(_printed(icp_run.main, argv))
    debug_files = list(tmp_path.rglob("*.icplog.npz"))
    assert len(debug_files) == 1 and load_log(str(debug_files[0]))["meta"]["n_iterations"] \
        == got["iterations"]
    ref = cs.icp_run_printed(_printed(jicp_run.main, argv))
    assert got["termination"] == ref["termination"] and got["pairings"] > 0
    assert cs.iterations_agree(got["iterations"], ref["iterations"])


# ---------------------------------------------------------------- mm-filter
def test_mm_filter_matches_jax(inputs):
    files, root = inputs["files"], inputs["root"]
    argv = ["-i", files["npz0"], "-p", files["filters"]]
    _printed(mm_filter.main, argv + ["-o", root / "port_filtered.mm.npz"])
    _printed(jmm_filter.main, argv + ["-o", root / "jax_filtered.mm.npz"])
    mm, jmm = (load_mm_file(str(root / "port_filtered.mm.npz")),
               jload_mm_file(str(root / "jax_filtered.mm.npz")))
    got, ref = cs.mm_filter_summary(mm), cs.mm_filter_summary(jmm)
    assert sorted(got) == sorted(ref)
    # every layer no class threshold decides: equal
    for name in sorted(ref):
        if name == "planes" or name in cs.EDGES_PLANES_LAYERS:
            continue
        a, b = mm.layers[name], jmm.layers[name]
        assert int(a.count) == int(b.count), name
        np.testing.assert_array_equal(a.xyz.numpy(), np.asarray(b.xyz), err_msg=name)
        for ch in ("intensity", "ring", "time"):
            np.testing.assert_array_equal(getattr(a, ch).numpy(), np.asarray(getattr(b, ch)))
    # FilterEdgesPlanes' layers and planes by the chip's check, from the JAX
    # package's record (edges_planes_record, as scripts/torch_apps_reference.py
    # writes it): only rows of threshold voxels may differ
    raw = load_mm_file(files["npz0"]).layers["raw"]
    record = cs.edges_planes_record(jmm, raw.xyz[: int(raw.count)].numpy())
    near_voxels, _ = cs.held_edges_planes(FilterEdgesPlanes(voxel_filter_resolution=0.5), raw,
                                          mm, record, "mm-filter")
    print(f"mm-filter: {len(ref) - 1} layers; {near_voxels} threshold voxels")


def test_mm_filter_rename_layer(inputs, tmp_path):
    out = tmp_path / "renamed.mm.npz"
    text = _printed(mm_filter.main, ["-i", inputs["files"]["mm0"], "-o", out,
                                     "--rename-layer", "raw=lidar"])
    jtext = _printed(jmm_filter.main, ["-i", inputs["files"]["mm0"], "-o", tmp_path / "j.mm.npz",
                                       "--rename-layer", "raw=lidar"])
    assert text.split(": ", 1)[1] == jtext.split(": ", 1)[1]
    assert list(load_mm_file(str(out)).layers) == ["lidar"]
    with pytest.raises(SystemExit):
        mm_filter.main(["-i", str(inputs["files"]["mm0"]), "-o", str(out),
                        "--rename-layer", "nope=x"])


# -------------------------------------------------------- sm2mm and sm-cli
SM2MM_YAML = {
    "generators": [{"class_name": "mp2p_icp_filters::Generator",
                    "params": {"target_layer": "raw"}}],
    "filters": [
        {"class_name": "mp2p_icp_filters::FilterDeskew",
         "params": {"input_pointcloud_layer": "raw", "output_pointcloud_layer": "deskewed",
                    "silently_ignore_no_timestamps": True}},
        {"class_name": "mp2p_icp_filters::FilterMerge",
         "params": {"input_pointcloud_layer": "deskewed", "target_layer": "map_points",
                    "target_capacity": 32768, "input_layer_in_local_coordinates": True}},
        {"class_name": "mp2p_icp_filters::GeneratorVoxelMap",
         "params": {"input_pointcloud_layer": "deskewed", "output_voxel_layer": "voxelmap",
                    "resolution": 0.5, "capacity": 8192, "carve_free_space": True}},
    ],
    "final_filters": [
        {"class_name": "mp2p_icp_filters::FilterRemoveByVoxelOccupancy",
         "params": {"input_pointcloud_layer": "map_points", "input_voxel_layer": "voxelmap",
                    "output_layer_static_objects": "static_points",
                    "output_layer_dynamic_objects": "dynamic_points",
                    "occupancy_threshold": 0.4}}],
}


@pytest.fixture(scope="module")
def simple_map(tmp_path_factory, _ask_for_the_cpu):
    from mp2p_icp_tpu_torch.eval.lidar_sim import make_street_sequence

    root = tmp_path_factory.mktemp("sm")
    gt, tw, scans = make_street_sequence(4, n_rings=8, n_azimuth=256)
    sm, _ = cs.sm2mm_build(cs.sm2mm_inputs(gt, tw, scans, n_keyframes=4), precise=False)
    path = root / "street.sm.npz"
    sm.save(path)
    (root / "sm2mm.yaml").write_text(yaml.safe_dump(SM2MM_YAML))
    return root, path


def test_sm2mm_app_matches_jax(simple_map):
    root, path = simple_map
    argv = ["-i", path, "-p", root / "sm2mm.yaml"]
    text = _printed(sm2mm_app.main, argv + ["-o", root / "port.mm.npz", "--to-index", 3])
    jtext = _printed(jsm2mm_app.main, argv + ["-o", root / "jax.mm.npz", "--to-index", 3])
    assert text.split(": ", 1)[1] == jtext.split(": ", 1)[1]
    mm, jmm = load_mm_file(str(root / "port.mm.npz")), jload_mm_file(str(root / "jax.mm.npz"))
    assert list(mm.layers) == list(jmm.layers)
    for name in ("map_points", "static_points", "dynamic_points"):
        a, b = mm.layers[name], jmm.layers[name]
        assert int(a.count) == int(b.count), name
        np.testing.assert_allclose(a.to_numpy(), b.to_numpy(), atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(mm.layers["voxelmap"].keys.numpy(),
                                  np.asarray(jmm.layers["voxelmap"].keys))


@pytest.mark.parametrize("command", [
    ["info"], ["cut", "--from-index", 1, "--to-index", 3], ["tf", "-t", "1 2 0 0.1 0 0"],
    ["level"], ["trim", "--min-corner", "12.5 -5 -5", "--max-corner", "30 5 5"],
    ["export-kfs"], ["export-rawlog"], ["join"]])
def test_sm_cli_matches_jax(simple_map, tmp_path, command):
    _, path = simple_map
    name, rest = command[0], command[1:]
    if name == "info":
        text = _printed(sm_cli.main, ["info", path])
        assert text == _printed(jsm_cli.main, ["info", path])
        return
    suffix = {"export-kfs": ".txt", "export-rawlog": ".rawlog.npz"}.get(name, ".sm.npz")
    out, jout = tmp_path / f"port{suffix}", tmp_path / f"jax{suffix}"
    inputs_ = [path, path] if name == "join" else [path]
    text = _printed(sm_cli.main, [name] + inputs_ + rest + ["-o", out])
    jtext = _printed(jsm_cli.main, [name] + inputs_ + rest + ["-o", jout])
    assert text.replace(str(out), "OUT") == jtext.replace(str(jout), "OUT")
    if suffix == ".txt":
        np.testing.assert_allclose(np.loadtxt(out), np.loadtxt(jout), atol=2e-6)
    elif suffix == ".sm.npz":
        kfs, jkfs = SimpleMap.load(str(out)).keyframes, JSimpleMap.load(str(jout)).keyframes
        assert len(kfs) == len(jkfs) > 0
        for a, b in zip(kfs, jkfs):
            np.testing.assert_allclose(a.pose.R.numpy(), np.asarray(b.pose.R), atol=1e-6)
            np.testing.assert_allclose(a.pose.t.numpy(), np.asarray(b.pose.t), atol=1e-5)
    else:
        from mp2p_icp_tpu.io.rawlog import Rawlog as JRawlog
        from mp2p_icp_tpu_torch.io.rawlog import Rawlog

        rl, jrl = Rawlog.load(str(out)), JRawlog.load(str(jout))
        assert rl.frames == jrl.frames
        assert [o.class_name for o in rl.observations] == [o.class_name for o in jrl.observations]
        assert [o.text for o in rl.observations] == [o.text for o in jrl.observations]
