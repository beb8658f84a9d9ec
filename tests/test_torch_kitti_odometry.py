"""The port's kitti-odometry against the JAX package's, on the CPU.

Mirrors tests/test_sequence.py and
tests/test_odometry_mapping.py::TestMappingCLI on a generated KITTI-format
sequence (5 frames of the street drive at 16 rings x 256 azimuths,
chip_smoke.write_apps_sequence): both packages' ``main`` sequentially, with
-B 2 and with --mapping. Bands: each frame-to-frame pose within the align
band (5e-3) of JAX's, ATE within max(1.5x, +0.01 m) of JAX's, map count
within 2%. --mapping --loop-closure on a short out-and-back drive
(chip_smoke.write_loop_sequence: 12 frames of 16 rings x 128 azimuths,
candidates at least 4 frames apart): JAX's candidates and accepted loops,
the printed line, poses within the align band of JAX's and ATE in the
trajectory band.
"""

import contextlib
import io

import numpy as np
import pytest

import chip_smoke as cs
import mp2p_icp_tpu_torch
from mp2p_icp_tpu.apps import kitti_odometry as jkitti_odometry
from mp2p_icp_tpu.io.mm import load_mm_file as jload_mm_file
from mp2p_icp_tpu_torch.apps import kitti_odometry
from mp2p_icp_tpu_torch.eval.trajectory import load_kitti_poses
from mp2p_icp_tpu_torch.io.mm import load_mm_file

FRAMES, RINGS, AZIMUTHS = 5, 16, 256
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
    root = tmp_path_factory.mktemp("kitti")
    bin_dir, gt_path, _ = cs.write_apps_sequence(root / "sequence", FRAMES, RINGS, AZIMUTHS)
    return {"root": root, "bin_dir": bin_dir, "gt": gt_path}


# ------------------------------------------------------------ kitti-odometry
MODES = {"sequential": [], "batched": ["-B", 2],
         "mapping": ["--mapping", "--map-capacity", 8192]}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_kitti_odometry_matches_jax(inputs, mode):
    root = inputs["root"]
    argv = ["--bin-dir", inputs["bin_dir"], "-c", KITTI, "--gt-poses", inputs["gt"]]
    extra = list(MODES[mode])
    if mode == "mapping":
        extra_port = extra + ["--out-map", root / f"port_{mode}.mm.npz"]
        extra_jax = extra + ["--out-map", root / f"jax_{mode}.mm.npz"]
    else:
        extra_port = extra_jax = extra
    text = _printed(kitti_odometry.main,
                    argv + ["--out-poses", root / f"port_{mode}.txt"] + extra_port)
    jtext = _printed(jkitti_odometry.main,
                     argv + ["--out-poses", root / f"jax_{mode}.txt"] + extra_jax)
    poses = load_kitti_poses(str(root / f"port_{mode}.txt"))
    jposes = load_kitti_poses(str(root / f"jax_{mode}.txt"))
    gt = load_kitti_poses(str(inputs["gt"]))
    ate, _, _ = cs.trajectory_errors(poses, gt)
    jate, _, _ = cs.trajectory_errors(jposes, gt)
    gaps = cs.pair_gaps(poses, jposes)
    print(f"[{mode}] ATE {ate:.4f} (JAX {jate:.4f}); pair gaps max {gaps.max():.3g}")
    assert poses.shape == (FRAMES, 4, 4)
    assert gaps.max() < 5e-3
    assert ate <= max(1.5 * jate, jate + 0.01)
    # the printed frame count and ATE as JAX's
    assert f"frames={FRAMES}" in text and f"frames={FRAMES}" in jtext
    assert f"ATE={jate:.3f}m" in text
    got = cs.kitti_odometry_printed(text)
    assert got["iterations"] > 0
    if mode == "batched":
        assert len(got["batch_iterations"]) == 2  # 4 pairs in batches of 2
    if mode == "mapping":
        m, jm = (load_mm_file(str(root / "port_mapping.mm.npz")).layers["map"],
                 jload_mm_file(str(root / "jax_mapping.mm.npz")).layers["map"])
        assert m.capacity == jm.capacity == 8192
        assert abs(int(m.count) - int(jm.count)) <= 0.02 * int(jm.count)
        assert f"({int(m.count)} points)" in text


LOOP = dict(frames=12, rings=16, azimuths=128, min_gap=4, map_capacity=4096)


@pytest.fixture(scope="module")
def loop_inputs(tmp_path_factory, _ask_for_the_cpu):
    """The out-and-back sequence and the JAX package's mapping run with
    loop closure on it (its printed lines and its result)."""
    root = tmp_path_factory.mktemp("loop")
    bin_dir, gt_path, gt = cs.write_loop_sequence(root / "sequence", LOOP["frames"],
                                                  LOOP["rings"], LOOP["azimuths"])
    paths = sorted(bin_dir.glob("*.bin"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jout = jkitti_odometry.run_sequence_mapping(
            paths, KITTI, gt_poses=gt, map_capacity=LOOP["map_capacity"], loop_closure=True,
            loop_min_gap=LOOP["min_gap"])
    return {"root": root, "bin_dir": bin_dir, "gt": gt_path, "paths": paths, "jout": jout,
            "jtext": buf.getvalue()}


@pytest.mark.parametrize("entry", ["main", "run_sequence_mapping"])
def test_kitti_odometry_loop_closure_matches_jax(loop_inputs, entry):
    jout, jtext = loop_inputs["jout"], loop_inputs["jtext"]
    line = next(ln for ln in jtext.splitlines() if ln.startswith("[loop-closure]"))
    gt = load_kitti_poses(str(loop_inputs["gt"]))
    if entry == "main":
        out_path = loop_inputs["root"] / "port_loop.txt"
        text = _printed(kitti_odometry.main, [
            "--bin-dir", loop_inputs["bin_dir"], "-c", KITTI, "--gt-poses", loop_inputs["gt"],
            "--mapping", "--map-capacity", LOOP["map_capacity"], "--loop-closure",
            "--loop-min-gap", LOOP["min_gap"], "--out-poses", out_path, "--device", "cpu"])
        assert line in text.splitlines()  # [loop-closure] candidates=... accepted=...
        assert f"ATE={jout['ate_rmse']:.3f}m" in text
        poses = load_kitti_poses(str(out_path))
    else:
        out = kitti_odometry.run_sequence_mapping(
            loop_inputs["paths"], KITTI, gt_poses=gt, map_capacity=LOOP["map_capacity"],
            loop_closure=True, loop_min_gap=LOOP["min_gap"], verbose=False, device="cpu")
        assert [(i, j) for i, j, _q in out["loop_closures"]] == \
            [(i, j) for i, j, _q in jout["loop_closures"]]
        np.testing.assert_allclose([q for *_, q in out["loop_closures"]],
                                   [q for *_, q in jout["loop_closures"]], atol=1e-3)
        assert cs.pair_gaps(out["poses_odometry"], jout["poses_odometry"]).max() < 5e-3
        poses = out["poses"]
    assert "accepted=0" not in line
    assert cs.pair_gaps(poses, jout["poses"]).max() < 5e-3
    ate, _, _ = cs.trajectory_errors(poses, gt)
    assert ate <= max(1.5 * jout["ate_rmse"], jout["ate_rmse"] + 0.01)


def test_kitti_odometry_keeps_one_capacity(tmp_path):
    """The capacity comes from the largest scan (16 bytes a point), so a
    later, larger scan keeps the shapes of the first."""
    for i, n in enumerate((300, 900, 500)):
        np.zeros((n, 4), np.float32).tofile(tmp_path / f"{i:06d}.bin")
    assert kitti_odometry.sequence_capacity(sorted(tmp_path.glob("*.bin"))) == 1024
