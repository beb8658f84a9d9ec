"""CPU tests of the reader of the program's own spans and counter
(``benchmark/program_trace.py``), its metrics, and ``program_run.py``:
self time, innermost labelling, idle attribution and the counter's pairing
on a hand-built trace; ``trace.summarize``'s numbers, and every metric
read from them, unchanged when program spans are in the trace; a traced
CPU run of each cell with the program section beside the line.

    python -m pytest benchmark/tests -q
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness, program_run, program_trace, roofline, trace  # noqa: E402
from benchmark.harness import Readings, Window  # noqa: E402
from test_bench_harness import ROWS, hand_trace, tiny_tree  # noqa: E402

PER_LAYER = ("device.idle_pct", "host.launches_per_scan", "icp.syncs_per_iter", "knn_roofline")


def x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def program_spans():
    """The program's spans of hand_trace()'s window: one ICP iteration
    (1005-1060) with its match (1008-1042, the two kNN calls inside), a
    host read (1049-1059), and a map insert inside the bench's."""
    return [
        x("user_annotation", "icp.iter", 1005, 55),
        x("user_annotation", "icp.match", 1008, 34),
        x("user_annotation", "knn.query", 1011, 8),
        x("user_annotation", "knn.query", 1030, 9),
        x("user_annotation", "sync.icp_flags", 1049, 10),
        x("user_annotation", "map.insert", 1070, 15),
    ]


def with_program():
    return hand_trace() + program_spans() + [
        x("cuda_runtime", "cudaMemcpyAsync", 1080, 1, 9),
        x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1082, 1, 9),
    ]


RECORDS = [("knn.rows", (1, 1, torch.tensor(100, dtype=torch.int32), 200, False)),
           ("other.counter", (7,)),
           ("knn.rows", (1, 2, torch.tensor([50, 60]), torch.tensor(200), True))]


def test_self_time_innermost_labels_and_idle():
    p = program_trace.reduce(with_program(), RECORDS)["spans"]
    assert p["icp.iter"]["calls"] == 1 and p["knn.query"]["calls"] == 2
    assert p["icp.iter"]["seconds"] == pytest.approx(55e-6)
    assert p["icp.iter"]["self_s"] == pytest.approx((55 - 34 - 10) * 1e-6)
    assert p["icp.match"]["self_s"] == pytest.approx((34 - 8 - 9) * 1e-6)
    assert p["knn.query"]["self_s"] == pytest.approx(17e-6)
    # launches at 1012 and 1031 inside the kNN spans, 1071 in the insert
    assert p["knn.query"]["launches"] == 2 and p["icp.match"]["launches"] == 0
    assert p["icp.match"]["launches_incl"] == p["icp.iter"]["launches_incl"] == 2
    assert p["map.insert"]["launches"] == 1
    # the read: its copy issued at 1050 and the sync at 1053
    assert p["sync.icp_flags"]["dtoh"] == 1 and p["sync.icp_flags"]["syncs"] == 1
    assert p["sync.icp_flags"]["under"] == pytest.approx({"icp.iter": 10e-6})
    assert p["knn.query"]["under"] == pytest.approx({"icp.match": 17e-6, "icp.iter": 17e-6})
    # the copy to the card goes to the span open at its runtime call (1080)
    assert p["map.insert"]["htod"] == 1 and p["other"]["htod"] == 0
    # idle gaps by the program span open at their start (trace.summarize's
    # rule): 1000-1020 other, 1030-1035 knn.query, 1040-1052 icp.match,
    # 1053-1072 sync.icp_flags, 1077-1082 and 1083-1100 map.insert
    idle = {name: st["idle_s"] for name, st in p.items() if st["idle_s"]}
    assert idle == pytest.approx({"other": 20e-6, "knn.query": 5e-6, "icp.match": 12e-6,
                                  "sync.icp_flags": 19e-6, "map.insert": 22e-6})
    assert sum(idle.values()) == pytest.approx(78e-6)


def test_the_counter_pairs_with_the_knn_spans_in_order():
    knn = program_trace.reduce(with_program(), RECORDS)["knn"]
    (b1, d1), (b2, d2) = knn
    assert d1 == pytest.approx(10e-6) and d2 == pytest.approx(5e-6)
    assert b1 == pytest.approx(roofline.knn_bound_s(1, [100], [200], False))
    assert b2 == pytest.approx(roofline.knn_bound_s(1, [50, 60], [200], True))
    # the counts as trace.summarize's rows: the same roofline
    assert [b for b, _ in knn] == pytest.approx([b for b, _ in trace.summarize(hand_trace(),
                                                                              ROWS)["knn"]])
    # one record short, or none: no pairing
    assert program_trace.reduce(with_program(), RECORDS[:2])["knn"] is None
    assert program_trace.reduce(with_program(), [])["knn"] is None


def test_one_count_for_several_problems_is_each_problems():
    rec = (8, 3, torch.tensor([10]), torch.tensor(30), False)
    assert program_trace._rows(rec) == (8, [10, 10, 10], [30, 30, 30], False)
    assert program_trace._rows((1, 1, 6144, 16384, False)) == (1, [6144], [16384], False)


def _readings(summary):
    return Readings(setup_s=1.0, window=Window(0.0, 1.0, []), log=lambda *a: None,
                    trace=summary, scans=2, iterations=4)


def test_summarize_and_its_metrics_are_unchanged_by_program_spans():
    before = trace.summarize(hand_trace(), ROWS)
    after = trace.summarize(hand_trace() + program_spans(), ROWS)
    assert after == before
    for name in PER_LAYER:
        assert (harness.read_metric({"name": name}, _readings(after))
                == harness.read_metric({"name": name}, _readings(before))), name


def test_program_metrics_on_a_hand_built_trace():
    s = trace.summarize(with_program(), ROWS)
    s["program"] = program_trace.reduce(with_program(), RECORDS)
    r = _readings(s)
    assert harness.read_metric({"name": "icp.match_launches_per_iter"}, r) == 2.0
    assert harness.read_metric({"name": "icp.solve_launches_per_iter"}, r) == 0.0
    assert harness.read_metric({"name": "icp.host_wait_pct"}, r) == pytest.approx(100 * 10 / 55)
    assert harness.read_metric({"name": "knn.program_roofline"}, r) == pytest.approx(
        harness.read_metric({"name": "knn_roofline"}, r))
    # a trace without the program's spans (the parent's) reads nothing
    bare = _readings(trace.summarize(hand_trace(), ROWS))
    bare.trace["program"] = program_trace.reduce(hand_trace(), [])
    for name in program_run.PROGRAM_METRICS:
        assert harness.read_metric({"name": name}, bare) is None, name
        assert harness.read_metric({"name": name}, _readings(None)) is None, name


@pytest.mark.parametrize("cell", ["odom_kitti64.stream", "loc_corridor16m.scan",
                                  "odom_kitti64.fleet8"])
def test_a_traced_cpu_run_carries_the_program_section(tmp_path, cell):
    """The tiny cells on the CPU: the line of harness.run with the program
    section added, every key of it unchanged; the ICP loop's spans by
    iteration."""
    import mp2p_icp_tpu_torch

    root = tiny_tree(tmp_path)
    mp2p_icp_tpu_torch.set_default_device("cpu")
    try:
        line = program_run.with_program(harness.run)(cell, 11, 0.01, True, "cpu", root=root)
    finally:
        mp2p_icp_tpu_torch.set_default_device(None)
    assert line["correct"]
    spans = line["program_stages"]
    iters = spans["icp.iter"]["calls"]
    assert iters >= 1
    assert spans["icp.match"]["calls"] == spans["icp.solve"]["calls"] == iters
    sync = "sync.batch_running" if cell.endswith("fleet8") else "sync.icp_flags"
    assert spans[sync]["calls"] == iters and spans[sync]["under"]["icp.iter"] > 0
    root_span = "icp.align" if cell.startswith("loc") else "odometry.step"
    assert spans["icp.iter"]["under"][root_span] == pytest.approx(spans["icp.iter"]["seconds"])
    # no kernel on the CPU: the launch counts read 0 and the roofline nothing
    assert line["program_metrics"]["icp.match_launches_per_iter"] == 0.0
    assert line["program_metrics"]["knn.program_roofline"] is None
    assert 0 < line["program_metrics"]["icp.host_wait_pct"] < 100
    assert set(line) == {"correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "stages", "iterations_per_scan", "checks", "program_stages",
                         "program_metrics"}
