"""CPU tests of the benchmark's harness: data-driven dispatch, the imports
it may not make, the run without a card, and the metrics' arithmetic on
hand-built inputs.

    python -m pytest benchmark/tests -q
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, roofline, stats, trace  # noqa: E402
from benchmark.harness import Readings, Window  # noqa: E402

TINY = Path(__file__).resolve().parent / "tiny"
FORBIDDEN = {"jax", "jaxlib", "flax", "mp2p_icp_tpu"}


def tiny_tree(dst: Path) -> Path:
    """A copy of the benchmark with the CPU tests' configurations and
    traffic (tests/tiny/) in place of the full ones; returns its benchmark
    directory."""
    shutil.copytree(ROOT / "benchmark", dst / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    spec = harness.spec_of(dst / "benchmark")
    for c in spec["configs"]:
        shutil.copy(TINY / Path(c["file"]).name, dst / c["file"])
    for f in (TINY / "traffic").glob("*.json"):
        shutil.copy(f, dst / "benchmark" / "traffic" / f.name)
    for f in (TINY / "limits").glob("*.json"):
        shutil.copy(f, dst / "benchmark" / "limits" / f.name)
    return dst / "benchmark"


def files_of(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_added_cell_configuration_traffic_and_metric_are_found_by_name(tmp_path):
    root = tiny_tree(tmp_path)
    before = files_of(root)
    spec = harness.spec_of(root)
    # a new configuration: the odometry one at another map capacity
    cfg = json.loads((root / "configs" / "kitti_hdl64_odometry.json").read_text())
    cfg["mapper"]["map_capacity"] *= 2
    (root / "configs" / "kitti_bigmap.json").write_text(json.dumps(cfg))
    # a new traffic mix of an existing kind, a new metric reader
    (root / "traffic" / "short.json").write_text(json.dumps(
        {"kind": "odometry_stream", "pass_frames": 3, "progress_every": 1, "warm_frames": 2,
         "trace_steps": [1, 2]}))
    (root / "metrics" / "window_requests.py").write_text(
        "def read(r):\n    return float(len(r.window.requests))\n")
    spec["configs"].append({"name": "kitti_bigmap", "source": "https://example.org/x",
                            "file": "benchmark/configs/kitti_bigmap.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "kitti_bigmap.short", "config": "kitti_bigmap",
                              "traffic": "short", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "window_requests", "unit": "requests",
                               "better": "higher", "bound": 0.01, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = files_of(root)
    assert all(after[p] == b for p, b in before.items())  # no file that was there changed

    import mp2p_icp_tpu_torch

    mp2p_icp_tpu_torch.set_default_device("cpu")
    try:
        line = harness.run("kitti_bigmap.short", 7, 0.01, False, "cpu", root=root)
    finally:
        mp2p_icp_tpu_torch.set_default_device(None)
    assert line["metrics"]["window_requests"]["value"] == 2.0  # frames 1 and 2 of one pass
    # latency_ms_p95 names its cells, and not this one
    assert set(line["metrics"]) == {"scans_per_s", "setup_s", "window_requests"}


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_either_package():
    mods = _modules_after("import benchmark.reference, benchmark.checks, benchmark.scenes")
    assert not mods & (FORBIDDEN | {"mp2p_icp_tpu_torch"})


def test_a_run_loads_no_jax(tmp_path):
    root = tiny_tree(tmp_path)
    mods = _modules_after(
        "import mp2p_icp_tpu_torch as T\nT.set_default_device('cpu')\n"
        "from pathlib import Path\nfrom benchmark import harness\n"
        f"harness.run('loc_corridor16m.scan', 3, 0.01, True, 'cpu', root=Path({str(root)!r}))")
    assert "mp2p_icp_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "odom_kitti64.stream",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("values,q,want", [
    ([1.0], 95, 1.0),
    ([3.0, 1.0, 2.0], 50, 2.0),
    (list(range(1, 101)), 95, 95.05),
    ([10.0, 20.0], 95, 19.5),
])
def test_percentile_over_all_requests(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want)


def test_latency_and_rate_readers_take_every_request():
    reqs = [(0.0, 0.1, 1), (0.1, 0.3, 1), (0.3, 1.3, 1), (1.3, 2.0, 2)]
    r = Readings(setup_s=5.0, window=Window(0.0, 2.0, reqs), log=lambda *a: None)
    assert harness.read_metric({"name": "scans_per_s"}, r) == pytest.approx(5 / 2.0)
    assert harness.read_metric({"name": "latency_ms_p95"}, r) == pytest.approx(
        stats.percentile([100, 200, 1000, 700], 95))
    assert harness.read_metric({"name": "setup_s"}, r) == 5.0


def test_union_length():
    assert stats.union_length([(0, 1), (0.5, 2), (3, 4), (3.5, 3.7)]) == pytest.approx(3.0)
    assert stats.union_length([]) == 0.0


def test_knn_bound_counts_valid_rows_and_a_shared_map_once():
    # 100 x 200 pairs, 9 instructions each, against 300 rows of 12 bytes + 100 results
    ops = 100 * 200 * 9 / roofline.FP32_INSTRUCTIONS_PER_S
    moved = (12 * 300 + 8 * 100) / roofline.BYTES_PER_S
    assert roofline.knn_bound_s(1, [100], [200], False) == pytest.approx(max(ops, moved))
    big = roofline.knn_bound_s(1, [8192] * 8, [65536], True)
    assert big == pytest.approx(8 * 8192 * 65536 * 9 / roofline.FP32_INSTRUCTIONS_PER_S)
    own = roofline.knn_bound_s(8, [10, 20], [30, 40], False)
    assert own == pytest.approx(max((10 * 30 + 20 * 40) * 9 / roofline.FP32_INSTRUCTIONS_PER_S,
                                    (12 * 100 + 8 * 30 * 8) / roofline.BYTES_PER_S))


def hand_trace():
    """A window of 100 us: two kNN spans and one map insert; kernels busy
    for 10 + 5 + 5 us (two overlapping), one host read."""
    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e
    return [
        x("user_annotation", "bench.window", 1000, 100),
        x("user_annotation", "bench.align", 1000, 60),
        x("user_annotation", "bench.knn", 1010, 10),
        x("cuda_runtime", "cudaLaunchKernel", 1012, 2, 1),
        x("kernel", "knn_sweep_kernel<1>", 1020, 10, 1),
        x("user_annotation", "bench.knn", 1030, 10),
        x("cuda_runtime", "cudaLaunchKernel", 1031, 2, 2),
        x("kernel", "knn_sweep_kernel<1>", 1035, 5, 2),
        x("cuda_runtime", "cudaMemcpyAsync", 1050, 3, 3),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1052, 1, 3),
        x("cuda_runtime", "cudaStreamSynchronize", 1053, 5),
        x("user_annotation", "bench.map_insert", 1070, 20),
        x("cuda_runtime", "cudaLaunchKernel", 1071, 2, 4),
        x("kernel", "scatter", 1072, 5, 4),
        x("kernel", "outside the window", 2000, 5),
    ]


ROWS = [(1, [100], [200], False), (1, [50, 60], [200], True)]


def test_trace_summary_on_a_hand_built_trace():
    s = trace.summarize(hand_trace(), ROWS)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(21e-6)  # 10 + 5 + 1 (copy) + 5
    assert s["launches"] == 3 and s["syncs"] == 1 and s["dtoh"] == 1
    assert s["stages"]["knn"]["launches"] == 2
    assert s["stages"]["map_insert"]["launches"] == 1
    assert s["stages"]["align"]["syncs"] == 1
    assert s["device_ops"]["knn_sweep_kernel<1>"] == pytest.approx(15e-6)
    (b1, d1), (b2, d2) = s["knn"]
    assert d1 == pytest.approx(10e-6) and d2 == pytest.approx(5e-6)
    assert b1 == pytest.approx(roofline.knn_bound_s(1, [100], [200], False))
    # idle gaps by the span open at their start: 1000-1020 align, 1030-1035
    # knn, 1040-1052 align, 1053-1072 align, 1077-1100 map_insert
    assert s["idle_by_stage"] == pytest.approx({"align": 51e-6, "knn": 5e-6,
                                                "map_insert": 23e-6})


def test_per_layer_readers_on_a_hand_built_trace():
    s = trace.summarize(hand_trace(), ROWS)
    r = Readings(setup_s=1.0, window=Window(0.0, 1.0, []), log=lambda *a: None, trace=s,
                 scans=2, iterations=4)
    assert harness.read_metric({"name": "device.idle_pct"}, r) == pytest.approx(79.0)
    assert harness.read_metric({"name": "host.launches_per_scan"}, r) == pytest.approx(1.5)
    assert harness.read_metric({"name": "icp.syncs_per_iter"}, r) == pytest.approx(0.5)
    # the call of one problem and the batched call together, over their kernels
    assert harness.read_metric({"name": "knn_roofline"}, r) == pytest.approx(
        100 * (roofline.knn_bound_s(1, [100], [200], False)
               + roofline.knn_bound_s(1, [50, 60], [200], True)) / 15e-6)


def test_missing_counts_leave_the_roofline_out():
    s = trace.summarize(hand_trace(), None)
    assert s["knn"] is None
    r = Readings(setup_s=1.0, window=Window(0.0, 1.0, []), log=lambda *a: None, trace=s,
                 scans=2, iterations=4)
    assert harness.read_metric({"name": "knn_roofline"}, r) is None
