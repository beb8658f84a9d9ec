"""The program's spans and counter (``mp2p_icp_tpu_torch/utils/profiler.py``).

Under a CPU ``torch.profiler`` trace, ``ICP.align``, the batched align and
``OdometryMapper`` frames emit their spans nested as a request's: the root
(``icp.align``, ``odometry.step``), the stages, one ``icp.iter`` per ICP
iteration holding ``icp.match`` (with ``knn.query`` inside), ``icp.solve``,
``icp.terminate`` and the ``sync.<site>`` host reads, then ``icp.results``.
The ``knn.rows`` counter records one entry per ``knn.query`` span, the
``gn.solve`` counter one per Gauss-Newton solve and the ``icp.terminate``
counter one per termination test (the plain paths here; a ``cuda`` case
sees the termination kernel's ``fused`` records on the card). The
poses are bit-equal with tracing on and off; with tracing off a span is
one shared no-op that opens no ``record_function`` and costs at most a
microsecond. One ``cuda`` case (skipped without a card) checks on the
trace's clock that the sweep kernels are launched inside ``icp.match``.
"""

import json
import time
import timeit

import numpy as np
import pytest
import torch

import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.eval.lidar_sim import (
    make_scene,
    make_street_sequence,
    sample_scan,
    scan_to_pointcloud,
)
from mp2p_icp_tpu_torch.filters import FilterDecimateVoxels, FilterDeskew
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters
from mp2p_icp_tpu_torch.matchers import (
    LayerMatch,
    MatcherPoint2Plane,
    MatcherPointsDistanceThreshold,
)
from mp2p_icp_tpu_torch.odometry import BatchedOdometryMapper, OdometryMapper
from mp2p_icp_tpu_torch.parallel import make_batched_align, stack_pytrees
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn
from mp2p_icp_tpu_torch.utils import profiler
from mp2p_icp_tpu_torch.utils.profiler import Profiler, drain_counts, profile_scope

LOOP = ("icp.match", "icp.solve", "icp.terminate", "sync.icp_flags")


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _icp():
    return ICP(matchers=[MatcherPointsDistanceThreshold(threshold=2.0)],
               solvers=[SolverHorn(run_up_to_iteration=2),
                        SolverGaussNewton(run_from_iteration=3,
                                          gn_params=GNParams(max_iterations=2))])


def _pair(seed, n=512, device="cpu"):
    """A scan-to-scan pair of the street scene: (local, global, guess)."""
    scene = make_scene(np.random.RandomState(0), n=20_000, extent=30.0)
    g = sample_scan(scene, np.random.RandomState(seed), n=n)
    loc = sample_scan(scene, np.random.RandomState(seed + 100), n=n)
    gt = se3.from_xyz_ypr(0.4, 0.05, 0.0, 0.02, 0.0, 0.0, device=device)
    loc = se3.apply(se3.inverse(gt), torch.from_numpy(loc).to(device))
    return ({"raw": PointCloud.from_numpy(loc.cpu().numpy(), device=device)},
            {"raw": PointCloud.from_numpy(g, device=device)},
            se3.identity(device=device))


def _mapper(scale=8):
    """bench_torch.odometry_mapper() with every capacity divided by scale."""
    return OdometryMapper(
        icp=ICP(matchers=[MatcherPoint2Plane(
                    distance_threshold=1.5, use_point_normals=True,
                    layer_matches=(LayerMatch(global_layer="map", local_layer="decimated"),))],
                solvers=[SolverGaussNewton(gn_params=GNParams(max_iterations=3))]),
        params=ICPParameters(max_iterations=30, crop_capacity=(1 << 14) // scale,
                             crop_extra_margin=3.0),
        filters=[FilterDeskew(input_pointcloud_layer="raw", output_pointcloud_layer="deskewed"),
                 FilterDecimateVoxels(input_pointcloud_layer=("deskewed",),
                                      output_pointcloud_layer="decimated",
                                      voxel_filter_resolution=0.5,
                                      output_capacity=6144 // scale, backend="sort")],
        incremental_map_resolution=0.5, normals_knn=8, normals_radius=1.5,
        normals_query_capacity=2048 // scale, local_layer="decimated", map_layer="map",
        map_capacity=(1 << 15) // scale)


@pytest.fixture(scope="module")
def drive():
    gt, twists, scans = make_street_sequence(4, n_rings=16, n_azimuth=256)
    return twists, [{"raw": scan_to_pointcloud(s, capacity=4096)} for s in scans]


def _traced(fn):
    """(fn's result, [(start, end, name, parent name)] of the program's
    spans in start order, the counter's records)."""
    drain_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    records = drain_counts()
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.name.split(".")[0] in ("icp", "knn", "sync", "odometry", "filters",
                                                "map", "normals")),
                   key=lambda s: (s[0], -s[1]))
    nested, stack = [], []
    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        assert not stack or e <= stack[-1][1], f"{name} crosses {stack[-1][2]}"
        nested.append((s, e, name, stack[-1][2] if stack else None))
        stack.append((s, e, name))
    return out, nested, records


def _split(records):
    """The values of the ``knn.rows``, the ``gn.solve`` and the
    ``icp.terminate`` records; no other counter records anything."""
    knn = [v for n, v in records if n == "knn.rows"]
    gn = [v for n, v in records if n == "gn.solve"]
    term = [v for n, v in records if n == "icp.terminate"]
    assert len(knn) + len(gn) + len(term) == len(records)
    return knn, gn, term


def _children(spans, parent):
    return [n for _, _, n, p in spans if p == parent]


def _parents(spans, name):
    return {p for _, _, n, p in spans if n == name}


def test_align_spans_nest_under_the_root():
    local, glob, guess = _pair(1)
    icp, params = _icp(), ICPParameters(max_iterations=12)
    res, spans, records = _traced(lambda: icp.align(local, glob, guess, params))
    assert [n for _, _, n, p in spans if p is None] == ["icp.align"]
    iters = [n for n in _children(spans, "icp.align") if n == "icp.iter"]
    assert len(iters) == res.n_iterations > 2
    assert _children(spans, "icp.align")[-1] == "icp.results"
    assert _parents(spans, "icp.match") == {"icp.iter"}
    assert _parents(spans, "knn.query") == {"icp.match"}
    assert _parents(spans, "sync.icp_flags") == {"icp.iter"}
    for name in LOOP:
        assert sum(n == name for _, _, n, _ in spans) == res.n_iterations, name
    # one counter record per kNN call, in order, and one per Gauss-Newton
    # solve (iterations 3 on; the CPU's plain path, 512 pt2pt rows)
    knn, gn, term = _split(records)
    assert len(knn) == sum(n == "knn.query" for _, _, n, _ in spans) == res.n_iterations
    assert all(vals[0] == 1 and vals[1] == 1 for vals in knn)
    assert int(knn[0][2]) == 512 and int(knn[0][3]) == 512
    assert gn == [("plain", None, 512)] * (res.n_iterations - 3)
    assert term == [("plain", None)] * res.n_iterations  # one per termination test

    plain = icp.align(local, glob, guess, params)
    assert torch.equal(plain.optimal_tf.R, res.optimal_tf.R)
    assert torch.equal(plain.optimal_tf.t, res.optimal_tf.t)
    assert plain.n_iterations == res.n_iterations


def test_quality_checkpoint_reads_inside_its_span():
    local, glob, guess = _pair(2)
    params = ICPParameters(max_iterations=6, quality_checkpoints=((2, 0.0),))
    _, spans, _ = _traced(lambda: _icp().align(local, glob, guess, params))
    assert _parents(spans, "icp.quality") == {"icp.iter"}
    assert _parents(spans, "sync.icp_quality") == {"icp.quality"}


def test_batched_align_spans_under_vmap():
    pairs = [_pair(s) for s in (3, 4)]
    local = stack_pytrees([p[0] for p in pairs])
    glob = stack_pytrees([p[1] for p in pairs])
    guess = stack_pytrees([p[2] for p in pairs])
    run = make_batched_align(_icp(), ICPParameters(max_iterations=10))
    res, spans, records = _traced(lambda: run(local, glob, guess))
    loops = int(res.n_iterations.max())
    assert sum(n == "icp.iter" for _, _, n, _ in spans) == loops
    assert _parents(spans, "icp.match") == _parents(spans, "sync.batch_running") == {"icp.iter"}
    assert _parents(spans, "knn.query") == {"icp.match"}
    # ICP._step's termination under vmap, and each problem's stop after it
    assert sum(n == "icp.terminate" for _, _, n, _ in spans) == 2 * loops
    assert _parents(spans, "icp.results") == {None}
    knn, gn, term = _split(records)
    assert len(knn) == sum(n == "knn.query" for _, _, n, _ in spans) == loops
    assert gn == [("plain", None, 512)] * (loops - 3)  # one record per vmapped solve
    assert term == [("plain", None)] * loops  # one per vmapped test
    # under vmap the sweep gets one count per problem
    k, B, q, p, shared = knn[0]
    assert (k, B, shared) == (1, 2, False) and q.tolist() == p.tolist() == [512, 512]

    plain = run(local, glob, guess)
    assert torch.equal(plain.optimal_tf.R, res.optimal_tf.R)
    assert torch.equal(plain.optimal_tf.t, res.optimal_tf.t)


def _after_first_step(spans):
    """The spans from the first frame on: the seed map's filters, fit and
    insert come before it."""
    first = min(s for s, _, n, _ in spans if n == "odometry.step")
    return [x for x in spans if x[0] >= first]


def test_odometry_frames_are_rooted_at_their_step(drive):
    twists, frames = drive
    mapper = _mapper()
    res, spans, records = _traced(
        lambda: mapper.run(frames[:3], twists=twists[:3], dt=0.1, progress_every=1))
    frame_spans = _after_first_step(spans)
    for name in ("filters.deskew", "filters.decimate", "icp.crop", "icp.iter", "icp.results",
                 "map.insert", "normals.fit"):
        assert _parents(frame_spans, name) == {"odometry.step"}, name
    assert _parents(spans, "sync.map_probe") == {"map.insert"}
    assert _parents(frame_spans, "knn.query") == {"icp.match", "normals.fit"}
    # the drive's host waits between frames and after the last are outside them
    roots = [n for _, _, n, p in frame_spans if p is None]
    assert roots == (["odometry.step", "sync.drive_iterations", "sync.progress"] * 2
                     + ["sync.drive_fetch", "sync.results"])
    assert sum(n == "icp.iter" for _, _, n, _ in spans) == int(np.sum(res["iterations"]))
    knn, gn, term = _split(records)
    assert len(knn) == sum(n == "knn.query" for _, _, n, _ in spans)
    assert len(gn) == len(term) == int(np.sum(res["iterations"]))

    plain = mapper.run(frames[:3], twists=twists[:3], dt=0.1, progress_every=1)
    np.testing.assert_array_equal(plain["poses"], res["poses"])


def test_fleet_frames_are_rooted_at_their_step(drive):
    twists, frames = drive
    fleet = BatchedOdometryMapper(_mapper())
    streams, tws = [frames[0:2], frames[2:4]], [twists[0:2], twists[2:4]]
    res, spans, records = _traced(lambda: fleet.run(streams, twists=tws, dt=0.1))
    frame_spans = _after_first_step(spans)
    assert [n for _, _, n, p in frame_spans if p is None] == [
        "odometry.step", "sync.drive_iterations", "sync.drive_fetch", "sync.results"]
    for name in ("icp.crop", "icp.iter", "map.insert", "normals.fit"):
        assert _parents(frame_spans, name) == {"odometry.step"}, name
    assert sum(n == "icp.iter" for _, _, n, _ in spans) == int(
        np.sum(res["iterations"].max(axis=0)))
    knn, gn, term = _split(records)
    assert len(knn) == sum(n == "knn.query" for _, _, n, _ in spans)
    assert {r[1] for r in knn} == {1, 2}  # the seeds' fits, then the fleet's sweeps
    assert len(gn) == len(term) == sum(n == "icp.iter" for _, _, n, _ in spans)

    plain = fleet.run(streams, twists=tws, dt=0.1)
    np.testing.assert_array_equal(plain["poses"], res["poses"])


def test_off_a_span_is_the_shared_no_op(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a record_function was opened with tracing off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profile_scope("icp.match") is profile_scope("knn.query")
    with profile_scope("icp.match"):
        pass
    profiler.count("knn.rows", 1)
    assert drain_counts() == []
    local, glob, guess = _pair(5, n=256)
    _icp().align(local, glob, guess, ICPParameters(max_iterations=3))


def test_off_a_span_costs_at_most_a_microsecond():
    """The budget of a span with tracing off: enter and exit on the host,
    the best of 100 timings of 2,000 spans on this thread's CPU clock (a
    busy host's preemptions left out), or on the wall clock where the
    thread's clock is too coarse to see them."""
    n = 2_000

    def spans():
        for _ in range(n):
            with profile_scope("icp.match"):
                pass

    per_span = min(timeit.repeat(spans, number=1, repeat=100, timer=time.thread_time)) / n
    if per_span == 0:
        per_span = min(timeit.repeat(spans, number=1, repeat=100, timer=time.perf_counter)) / n
    assert per_span <= 1e-6, f"{per_span * 1e6:.3f} us a span"


def test_an_installed_profiler_times_the_programs_spans():
    local, glob, guess = _pair(6)
    prof = Profiler()
    with prof.installed():
        res = _icp().align(local, glob, guess, ICPParameters(max_iterations=8))
        with prof.scope("outer"):
            pass
    assert profiler._installed is None
    stats = prof.stats()
    assert stats["icp.align"]["calls"] == stats["outer"]["calls"] == 1
    for name in ("icp.iter",) + LOOP:
        assert stats[name]["calls"] == res.n_iterations, name
    assert stats["icp.iter"]["total_s"] <= stats["icp.align"]["total_s"]
    with Profiler(enabled=False).installed():
        assert profile_scope("icp.align") is profile_scope("icp.iter")


@pytest.mark.cuda
def test_sweeps_launch_inside_the_match_span_on_card(tmp_path):
    """On the trace's clock: every sweep kernel's cudaLaunchKernel lies
    inside an icp.match span (and its knn.query)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kNN kernel has no CPU mode")
    local, glob, guess = _pair(7, n=4096, device="cuda")
    icp, params = _icp(), ICPParameters(max_iterations=8)
    icp.align(local, glob, guess, params)  # builds the kernels
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = icp.align(local, glob, guess, params)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = {name: [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                    if e.get("cat") == "user_annotation" and e["name"] == name]
             for name in ("icp.match", "knn.query")}
    assert len(spans["icp.match"]) == len(spans["knn.query"]) == res.n_iterations
    launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "Launch" in e["name"]
              and "correlation" in e.get("args", {})}
    sweeps = [launch[e["args"]["correlation"]] for e in events
              if e.get("cat") == "kernel" and "knn_sweep" in e["name"]]
    assert len(sweeps) >= res.n_iterations
    for ts in sweeps:
        for name in ("icp.match", "knn.query"):
            assert any(s <= ts <= e for s, e in spans[name]), (name, ts)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_terminate_counter_names_its_path(device):
    """One ``icp.terminate`` record per ICP iteration: ("plain", None) on
    the CPU, ("fused", 1) on the card, where the termination test is one
    kernel launch (``ops/icp_terminate.py``)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the termination kernel has no CPU mode")
    local, glob, guess = _pair(8, device=device)
    icp, params = _icp(), ICPParameters(max_iterations=8)
    icp.align(local, glob, guess, params)  # builds the card's kernels
    res, spans, records = _traced(lambda: icp.align(local, glob, guess, params))
    _, _, term = _split(records)
    want = ("fused", 1) if device == "cuda" else ("plain", None)
    assert term == [want] * res.n_iterations
    assert sum(n == "icp.terminate" for _, _, n, _ in spans) == res.n_iterations
