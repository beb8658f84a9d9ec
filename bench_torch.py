#!/usr/bin/env python3
"""Benchmark of the PyTorch port: bench.py's JSON line, measured on one GPU.

    python3 bench_torch.py [--device cuda|cpu] [--smoke]

The twin of bench.py for mp2p_icp_tpu_torch: the same workloads (scenes,
scans, seeds), the same configurations, the same repetitions and the same
keys, read from the same environment variables with the same defaults
(MP2P_BENCH_B, MP2P_BENCH_BATCHED, MP2P_BENCH_PROFILE, MP2P_BENCH_SCAN2MAP,
MP2P_BENCH_SCAN2MAP_BATCHED, MP2P_BENCH_S2M_B, MP2P_BENCH_SCAN2MAP_STREAM,
MP2P_BENCH_SCAN2MAP_16M, MP2P_BENCH_ODOMETRY, MP2P_BENCH_ODO_FRAMES,
MP2P_BENCH_ODO_B, MP2P_ODO_INC_MAP, MP2P_ODO_DEC_BACKEND). Sections, in
bench.py's order:

- scan to scan: the KITTI configuration on an 8192-point street pair, one
  warm-up and 40 timed aligns;
- the batch of B = 16 scan-to-scan pairs, each with its own map, in one
  ``make_batched_align`` call (K2 at 16 x 8192 x 8192), one warm-up and 8
  timed calls;
- ``stage_profile_ms``: 20 chained calls x 5 repetitions of the k=1 kNN, of
  one DistanceThreshold + Horn iteration and of one Adaptive + Gauss-Newton
  iteration, each time N eager calls between two synchronisations (so the
  host's issue time is in it), and one one-element op with its fetch;
- an 8192-point scan against the 1M-point corridor map cropped to 2^16 (K1),
  8 scans against the shared 1M map in one call (K2), the 2M map cropped to
  2^18 (K3) and the 16M map cropped to 2^18 (K3);
- the odometry loop: ``OdometryMapper.run`` over the 36-frame street drive
  (best of 2 after a warm-up), ``run_offline`` and the fleet of 8 streams
  through ``BatchedOdometryMapper.run_offline``;
- the C++ denominators: native/baseline_icp.cpp (scan to scan, 1M, 16M) and
  native/baseline_odometry.cpp, compiled from source into build/native/ with
  native/Makefile's flags at first use (the committed binaries are never
  run). Where a build or a run fails, their keys and ``vs_baseline`` are
  null and stderr says why.

stdout is one JSON line: {"metric", "value", "unit", "vs_baseline", "extra"};
``extra`` has bench.py's keys plus ``device`` and ``power_limit_w`` (nvidia-smi).
Everything else goes to stderr: the host CPU that ran the C++, and one
``[bench]`` line per timed repetition (its wall time, ended by a
synchronisation) so that medians can be taken. Every timed loop
synchronises the device before its clock starts and after its last call.

Any exception ends the run with a non-zero exit. A diverged result (an SE(3)
error of 0.1 or more, an ATE of 0.5 m or more) is reported as bench.py
reports it (0.0 for the speed, the error beside it) and the script then
exits 1 after printing the line.

``--device cpu`` runs the port's plain kNN on the CPU; ``--smoke`` shrinks
every size (scans, maps, crops, frames, repetitions) so that the whole run
takes about a minute there; its 2M and 16M maps are crops under
STREAM_BLOCK, so they take K1, not K3.

Imports torch, numpy and the port only.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import pathlib
import re
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from mp2p_icp_tpu_torch import convert, set_default_device
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.eval.lidar_sim import (
    make_scene,
    make_street_sequence,
    sample_scan,
    scan_to_pointcloud,
)
from mp2p_icp_tpu_torch.eval.trajectory import ate_rmse
from mp2p_icp_tpu_torch.filters import FilterDecimateVoxels, FilterDeskew
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters
from mp2p_icp_tpu_torch.matchers import (
    LayerMatch,
    MatcherAdaptive,
    MatcherPoint2Plane,
    MatcherPointsDistanceThreshold,
)
from mp2p_icp_tpu_torch.odometry import BatchedOdometryMapper, OdometryMapper
from mp2p_icp_tpu_torch.ops import cuda_build
from mp2p_icp_tpu_torch.ops import nn_bruteforce as nnb
from mp2p_icp_tpu_torch.parallel import make_batched_align, stack_pytrees
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.robust import RobustKernel
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn

REPO = pathlib.Path(__file__).resolve().parent
N_POINTS = 8192  # the bench pair: a decimated KITTI scan
GT = (1.1, 0.05, 0.01, 0.01, 0.002, 0.001)  # bench.py:154, the pair's true motion
ODO_RESOLUTION = 0.5
ODO_DT = 0.1
ERR_LIMIT = 0.1  # an SE(3) error at or above it is a diverged align
ATE_LIMIT = 0.5  # m: an odometry ATE at or above it is a diverged run
METRIC = "kitti_style_scan2scan_registrations_per_s_per_chip"


# --------------------------------------------------------------- workloads
def kitti_icp():
    """icp-settings-kitti.yaml as bench.py:167-193 configures it."""
    return ICP(
        matchers=[
            MatcherPointsDistanceThreshold(threshold=2.0, run_up_to_iteration=5),
            MatcherAdaptive(confidence_interval=0.75, first_to_second_distance_max=1.2,
                            absolute_max_search_distance=2.0, run_from_iteration=6),
        ],
        solvers=[
            SolverHorn(run_up_to_iteration=5),
            SolverGaussNewton(run_from_iteration=6, gn_params=GNParams(
                max_iterations=3, kernel=RobustKernel.GEMAN_MCCLURE, kernel_param=0.15)),
        ],
    )


def street_pair(scene, seed_g, seed_l, n=N_POINTS):
    """(local layers, global layers) of one bench pair of n points, on the
    port's default device (the scan is moved into the sensor frame on the
    CPU)."""
    g = sample_scan(scene, np.random.RandomState(seed_g), n=n)
    loc = sample_scan(scene, np.random.RandomState(seed_l), n=n)
    gt = se3.from_xyz_ypr(*GT, device="cpu")
    loc = se3.apply(se3.inverse(gt), torch.from_numpy(loc)).numpy()
    return ({"raw": PointCloud.from_numpy(loc)}, {"raw": PointCloud.from_numpy(g)})


def corridor_scene(rng2, n, length=400.0):
    """bench.py:349-365: a long corridor, ground + side walls + cross-walls
    every 25 m, so every SE(3) axis is constrained locally."""
    t = rng2.uniform(0, length, n)
    kind = rng2.randint(0, 4, n)
    y = np.where(kind == 0, -6.0, np.where(kind == 1, 6.0, rng2.uniform(-6, 6, n)))
    z = np.where(kind < 2, rng2.uniform(0, 4, n),
                 np.where(kind == 2, 0.0, rng2.uniform(0, 2.5, n)))
    x = np.where(kind == 3, np.round(t / 25.0) * 25.0, t)
    return np.stack([x, y, z], 1).astype(np.float32)


def local_window(scene_pts, cx, rng3, n=8192, radius=50.0):
    """bench.py:374-378: n noisy points of the corridor within radius of x=cx."""
    m = np.abs(scene_pts[:, 0] - cx) < radius
    pts = scene_pts[m]
    idx = rng3.choice(pts.shape[0], size=n, replace=False)
    return (pts[idx] + 0.02 * rng3.randn(n, 3)).astype(np.float32)


def sensor_scan(corridor, cx, seed, err_ypr, n=N_POINTS):
    """(sensor-frame scan layers, guess = sensor pose, true pose) of one
    scan of the corridor at x=cx, as bench.py:380-385 and :436-451 make it;
    prepared on the CPU, returned on the port's default device."""
    scan = local_window(corridor, cx, np.random.RandomState(seed), n=n)
    sensor = se3.from_xyz_ypr(cx, 0.0, 1.5, 0.0, 0.0, 0.0, device="cpu")
    gt = se3.compose(sensor, se3.from_xyz_ypr(*err_ypr, device="cpu"))
    local = se3.apply(se3.inverse(gt), torch.from_numpy(scan)).numpy()
    return ({"raw": PointCloud.from_numpy(local, capacity=n)},
            convert.pose_from_numpy(sensor.R.numpy(), sensor.t.numpy()),
            convert.pose_from_numpy(gt.R.numpy(), gt.t.numpy()))


def map_icp():
    """The scan-to-map ICP of bench.py:386-402."""
    return ICP(
        matchers=[MatcherPointsDistanceThreshold(
            threshold=2.0, layer_matches=(LayerMatch(global_layer="map", local_layer="raw"),))],
        solvers=[SolverHorn(run_up_to_iteration=5),
                 SolverGaussNewton(run_from_iteration=6, gn_params=GNParams(max_iterations=3))],
    )


def odometry_mapper(incremental=True, decimation_backend="sort", scale=1):
    """The odometry benchmark's mapper (bench.py:621-683): FirstPoint
    decimation by ``decimation_backend`` (MP2P_ODO_DEC_BACKEND), the
    incremental voxel-hash map or, with ``incremental=False``
    (MP2P_ODO_INC_MAP=0), the sort-maintenance map; ``scale`` divides every
    capacity (the --smoke size)."""
    return OdometryMapper(
        icp=ICP(
            matchers=[MatcherPoint2Plane(
                distance_threshold=1.5, use_point_normals=True,
                layer_matches=(LayerMatch(global_layer="map", local_layer="decimated"),))],
            solvers=[SolverGaussNewton(gn_params=GNParams(max_iterations=3))],
        ),
        params=ICPParameters(max_iterations=30, crop_capacity=(1 << 14) // scale,
                             crop_extra_margin=3.0),
        filters=[
            FilterDeskew(input_pointcloud_layer="raw", output_pointcloud_layer="deskewed"),
            FilterDecimateVoxels(
                input_pointcloud_layer=("deskewed",), output_pointcloud_layer="decimated",
                voxel_filter_resolution=ODO_RESOLUTION, output_capacity=6144 // scale,
                backend=decimation_backend),
        ],
        incremental_map_resolution=ODO_RESOLUTION if incremental else None,
        normals_knn=8, normals_radius=1.5, normals_query_capacity=2048 // scale,
        map_filters=[] if incremental else [FilterDecimateVoxels(
            input_pointcloud_layer=("map",), output_pointcloud_layer="map",
            voxel_filter_resolution=ODO_RESOLUTION, output_capacity=(1 << 15) // scale)],
        local_layer="decimated", map_layer="map", map_capacity=(1 << 15) // scale,
    )


def odometry_frames(scans, capacity=1 << 16):
    """The rendered scans as raw layers of ``capacity`` rows on the port's
    default device."""
    return [{"raw": scan_to_pointcloud(scan, capacity=capacity)} for scan in scans]


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Everything the run's size decides: points per scan, the maps and
    their crops, the drive, the repetitions and the environment's defaults
    for the batch sizes and frame count."""

    n_points: int  # the scan-to-scan pairs
    s2m_points: int  # the scans of the corridor maps
    seq_reps: int  # timed scan-to-scan aligns after one warm-up
    batch_reps: int  # timed B = 16 calls after one warm-up
    chain: int  # stage profile: calls chained per repetition
    chain_reps: int
    corridor_16m: int  # the corridor's points (the 16M map)
    corridor: int  # ... without the 16M section
    map_1m: int
    crop_1m: int
    map_2m: int
    crop_2m: int
    crop_16m: int
    s2m_reps: int
    s2m_b_reps: int
    s2m_16m_reps: int
    odo_rings: int
    odo_azimuths: int
    odo_scale: int  # divides the mapper's capacities
    odo_warmups: int  # each odometry mode: the best of odo_runs after odo_warmups
    odo_runs: int
    cpp_reps: tuple  # C++ repetitions: scan to scan, 1M, 16M
    batch: str  # defaults of MP2P_BENCH_B, _S2M_B, _ODO_FRAMES, _ODO_B
    s2m_batch: str
    odo_frames: str
    odo_batch: str


FULL = Sizes(n_points=N_POINTS, s2m_points=N_POINTS, seq_reps=40, batch_reps=8, chain=20,
             chain_reps=5, corridor_16m=1 << 24, corridor=1 << 21, map_1m=1 << 20,
             crop_1m=1 << 16, map_2m=1 << 21, crop_2m=1 << 18, crop_16m=1 << 18, s2m_reps=10,
             s2m_b_reps=5, s2m_16m_reps=5, odo_rings=48, odo_azimuths=768, odo_scale=1,
             odo_warmups=1, odo_runs=2, cpp_reps=(5, 3, 1), batch="16", s2m_batch="8",
             odo_frames="36", odo_batch="8")
SMOKE = Sizes(n_points=2048, s2m_points=1024, seq_reps=2, batch_reps=1, chain=2, chain_reps=1,
              corridor_16m=1 << 16, corridor=1 << 15, map_1m=1 << 14, crop_1m=1 << 12,
              map_2m=1 << 15, crop_2m=1 << 12, crop_16m=1 << 12, s2m_reps=1, s2m_b_reps=1,
              s2m_16m_reps=1, odo_rings=16, odo_azimuths=256, odo_scale=4, odo_warmups=0,
              odo_runs=1, cpp_reps=(1, 1, 1), batch="2", s2m_batch="2", odo_frames="10",
              odo_batch="2")


# ---------------------------------------------------------------- the run
def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(label, n, call, device):
    """n calls of call(), each ended by a synchronisation, its wall time on
    a [bench] line; returns (seconds of all n, the last result)."""
    sync(device)
    walls, out = [], None
    for i in range(n):
        t0 = time.perf_counter()
        out = call()
        sync(device)
        walls.append(time.perf_counter() - t0)
        log(f"[bench] {label} rep {i}: {walls[-1] * 1e3:.3f} ms")
    return sum(walls), out


def pose_at(poses, b):
    return se3.Pose(poses.R[b], poses.t[b])


def card():
    """(name, power limit in W) of GPU 0 as nvidia-smi prints them."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(line)
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    return name, float(limit.split()[0])


def host_cpu():
    """The host CPU as /proc/cpuinfo names it: model name, vendor, family
    and model numbers, and the logical CPUs this process may use."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    return (f"{info.get('model name', 'unknown')} ({info.get('vendor_id', '?')}, family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}, "
            f"{len(os.sched_getaffinity(0))} logical CPUs)")


# ------------------------------------------------------- the C++ baselines
class NativeBaselines:
    """native/baseline_icp.cpp and baseline_odometry.cpp compiled from
    source into build/native/ with native/Makefile's CXX and CXXFLAGS, each
    at its first use; input files in a temporary directory. A failure
    returns None and says why on stderr."""

    def __init__(self, tmp):
        self.tmp = pathlib.Path(tmp)
        self.built = {}

    def binary(self, name):
        if name not in self.built:
            make = (REPO / "native" / "Makefile").read_text()
            var = dict(re.findall(r"^(CXX|CXXFLAGS)\s*\?=\s*(.*?)\s*$", make, re.M))
            out = REPO / "build" / "native" / name
            out.parent.mkdir(parents=True, exist_ok=True)
            cmd = [var["CXX"], *var["CXXFLAGS"].split(), "-o", str(out),
                   str(REPO / "native" / f"{name}.cpp")]
            t0 = time.perf_counter()
            subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=600)
            log(f"[bench] built {out.relative_to(REPO)} ({' '.join(cmd[:-3])}) in "
                f"{time.perf_counter() - t0:.1f} s")
            self.built[name] = out
        return self.built[name]

    def run(self, name, args, timeout):
        """The binary's JSON line, or None (and why on stderr)."""
        try:
            exe = self.binary(name)
            out = subprocess.run([str(exe), *map(str, args)], check=True, capture_output=True,
                                 text=True, timeout=timeout)
            return json.loads(out.stdout.strip())
        except subprocess.CalledProcessError as e:
            log(f"[bench] C++ {name} failed (exit {e.returncode}): {' '.join(map(str, e.cmd))}\n"
                f"{(e.stderr or '').strip()}")
        except (OSError, subprocess.TimeoutExpired, ValueError) as e:
            log(f"[bench] C++ {name} failed: {type(e).__name__}: {e}")
        return None

    def icp(self, g, loc, label, reps, threshold=2.0, guess=None):
        """baseline_icp on the pair (bench.measure_cpp_baseline's file form)."""
        path = self.tmp / f"{label}.bin"
        with open(path, "wb") as f:
            f.write(struct.pack("<i", g.shape[0]))
            f.write(np.ascontiguousarray(g, np.float32).tobytes())
            f.write(struct.pack("<i", loc.shape[0]))
            f.write(np.ascontiguousarray(loc, np.float32).tobytes())
        args = [path, reps, threshold] + (list(guess) if guess is not None else [])
        try:
            return self.run("baseline_icp", args, timeout=600)
        finally:
            path.unlink()

    def odometry(self, frames, twists, dt):
        """baseline_odometry on the frames (xyz and time of each return):
        (its JSON line, its [N, 3, 4] poses relative to frame 0) or None."""
        path, poses = self.tmp / "odometry.bin", self.tmp / "odometry_poses.txt"
        with open(path, "wb") as fh:
            fh.write(struct.pack("<if", len(frames), dt))
            for fr, tw in zip(frames, twists):
                pc = fr["raw"]
                n = int(pc.count)
                fh.write(struct.pack("<6f", *tw))
                fh.write(struct.pack("<i", n))
                rows = np.zeros((n, 4), np.float32)
                rows[:, :3] = pc.xyz[:n].cpu().numpy()
                rows[:, 3] = pc.time[:n].cpu().numpy()
                fh.write(rows.tobytes())
        out = self.run("baseline_odometry", [path, poses], timeout=1200)
        return None if out is None else (out, np.loadtxt(poses).reshape(-1, 3, 4))


# --------------------------------------------------------------- sections
def scan_to_scan(sz, device, cpp):
    """bench.py:151-208: the sequential aligns of the bench pair."""
    scene = make_scene(np.random.RandomState(0))
    loc, glob = street_pair(scene, 1, 2, sz.n_points)
    n = sz.n_points
    res = cpp.icp(glob["raw"].xyz[:n].cpu().numpy(), loc["raw"].xyz[:n].cpu().numpy(),
                  "pair", sz.cpp_reps[0])
    icp, params = kitti_icp(), ICPParameters(max_iterations=40)
    gt = se3.from_xyz_ypr(*GT)
    first = icp.align(loc, glob, se3.identity(), params)
    err = float(se3.error_log_norm(gt, first.optimal_tf))
    secs, last = timed("scan to scan", sz.seq_reps,
                       lambda: icp.align(loc, glob, se3.identity(), params), device)
    return {"scene": scene, "icp": icp, "params": params, "gt": gt, "loc": loc, "glob": glob,
            "cpp": res, "err": err, "scans_per_s": sz.seq_reps / secs,
            "iters": int(last.n_iterations)}


def batch_of_pairs(sz, device, s):
    """bench.py:219-253: B scan-to-scan pairs, each with its own map, in one
    call (no broadcast_globals): K2 at B x n x n."""
    B = int(os.environ.get("MP2P_BENCH_B", sz.batch))
    if os.environ.get("MP2P_BENCH_BATCHED", "1") != "1":
        return B, 0.0, -1.0
    pairs = [street_pair(s["scene"], 100 + 2 * b, 101 + 2 * b, sz.n_points) for b in range(B)]
    l_b = stack_pytrees([p[0] for p in pairs])
    g_b = stack_pytrees([p[1] for p in pairs])
    u_b = stack_pytrees([se3.identity() for _ in range(B)])
    fb = make_batched_align(s["icp"], s["params"])
    fb(l_b, g_b, u_b)
    secs, rb = timed(f"batched B={B}", sz.batch_reps, lambda: fb(l_b, g_b, u_b), device)
    err = max(float(se3.error_log_norm(s["gt"], pose_at(rb.optimal_tf, b))) for b in range(B))
    speed = sz.batch_reps * B / secs
    return B, (0.0 if err >= ERR_LIMIT else speed), err


def stage_profile(sz, device, s):
    """bench.py:258-333 in eager PyTorch: per unit, the time of n chained
    calls between two synchronisations over n (the host's issue time
    included; bench.py chained them inside one jit, which amortised the
    dispatch)."""
    icp, g_layers, l_layers = s["icp"], s["glob"], s["loc"]
    g_pc, l_pc = g_layers["raw"], l_layers["raw"]
    stage = {}

    def timed_chain(name, fn):
        fn()  # warm-up
        secs, _ = timed(f"stage {name}", sz.chain_reps, fn, device)
        stage[name] = round(secs / (sz.chain * sz.chain_reps) * 1e3, 4)

    def nn_chain():
        s_ = torch.zeros((), device=device)
        for _ in range(sz.chain):
            r = nnb.knn_bruteforce(l_pc.xyz + s_ * 0.0, l_pc.valid_mask(), g_pc.xyz,
                                   g_pc.valid_mask(), k=1, max_radius_sq=4.0)
            s_ = r.dist_sq[0, 0]
        return s_

    def iter_chain(m_active, s_active):
        def fn():
            acc = torch.zeros((), device=device)
            fin = torch.zeros(len(icp.solvers), dtype=torch.bool, device=device)
            t = torch.zeros(3, device=device)
            for _ in range(sz.chain):
                pose = se3.Pose(torch.eye(3, device=device), t + acc * 0.0)
                prs = icp._run_matchers(list(m_active), g_layers, l_layers, pose, 0)
                new, fin = icp._run_solvers(prs, pose, pose, 0, None, list(s_active), fin)
                acc = new.t[0]
            return acc

        return fn

    timed_chain("nn_k1_ms", nn_chain)
    timed_chain("dt_iter_ms", iter_chain((True, False), (True, False)))
    timed_chain("ad_iter_ms", iter_chain((False, True), (False, True)))
    tiny = torch.zeros((), device=device)
    (tiny + 1.0).item()
    t0 = time.perf_counter()
    for i in range(10):
        (tiny + float(i)).item()
    stage["dispatch_fetch_ms"] = round((time.perf_counter() - t0) / 10 * 1e3, 3)
    return stage


def scan_to_map(sz, device, cpp):
    """bench.py:339-555: the corridor maps (1M crop 2^16, the batch against
    the shared 1M map, 2M and 16M crop 2^18) and their C++ runs."""
    out = {"s2m": 0.0, "s2m_err": -1.0, "b": 0.0, "b_err": -1.0, "B": 0,
           "stream": 0.0, "stream_err": -1.0, "16m": 0.0, "16m_err": -1.0,
           "cpp": None, "cpp_16m": None}
    if os.environ.get("MP2P_BENCH_SCAN2MAP", "1") != "1":
        return out
    want_16m = os.environ.get("MP2P_BENCH_SCAN2MAP_16M", "1") == "1"
    corridor = corridor_scene(np.random.RandomState(33),
                              sz.corridor_16m if want_16m else sz.corridor)
    gm_layers = {"map": PointCloud.from_numpy(corridor[:sz.map_1m], capacity=sz.map_1m)}
    err_ypr = (0.9, 0.2, 0.02, 0.02, 0.003, -0.004)
    lm_layers, sensor, gt2 = sensor_scan(corridor, 200.0, 34, err_ypr, sz.s2m_points)
    icp2 = map_icp()

    def params(crop):
        return ICPParameters(max_iterations=40, crop_capacity=crop, crop_extra_margin=4.0)

    def one_map(label, layers, p, n_reps):
        r = icp2.align(lm_layers, layers, sensor, p)
        err = float(se3.error_log_norm(gt2, r.optimal_tf))
        secs, _ = timed(label, n_reps, lambda: icp2.align(lm_layers, layers, sensor, p), device)
        return (0.0 if err >= ERR_LIMIT else n_reps / secs), err

    p2 = params(sz.crop_1m)
    out["s2m"], out["s2m_err"] = one_map("scan to the 1M map", gm_layers, p2, sz.s2m_reps)

    if os.environ.get("MP2P_BENCH_SCAN2MAP_BATCHED", "1") == "1":
        B = out["B"] = int(os.environ.get("MP2P_BENCH_S2M_B", sz.s2m_batch))
        rngb = np.random.RandomState(35)
        problems = []
        for b in range(B):
            cx = 60.0 + 280.0 * b / max(B - 1, 1)
            ge = (0.9 * rngb.uniform(-1, 1), 0.2 * rngb.uniform(-1, 1), 0.02,
                  0.02 * rngb.uniform(-1, 1), 0.003, -0.004)
            problems.append(sensor_scan(corridor, cx, 100 + b, ge, sz.s2m_points))
        fnb = make_batched_align(icp2, p2, broadcast_globals=True)
        l_bb = stack_pytrees([pr[0] for pr in problems])
        u_bb = stack_pytrees([pr[1] for pr in problems])
        rb2 = fnb(l_bb, gm_layers, u_bb)
        err = max(float(se3.error_log_norm(pr[2], pose_at(rb2.optimal_tf, b)))
                  for b, pr in enumerate(problems))
        secs, _ = timed(f"scan to the 1M map, batched B={B}", sz.s2m_b_reps,
                        lambda: fnb(l_bb, gm_layers, u_bb), device)
        out["b"] = 0.0 if err >= ERR_LIMIT else sz.s2m_b_reps * B / secs
        out["b_err"] = err

    lx = lm_layers["raw"].xyz.cpu().numpy()
    guess = (200.0, 0.0, 1.5, 0.0, 0.0, 0.0)
    out["cpp"] = cpp.icp(corridor[:sz.map_1m], lx, "s2m", sz.cpp_reps[1], guess=guess)

    if os.environ.get("MP2P_BENCH_SCAN2MAP_STREAM", "1") == "1":
        gmap2 = {"map": PointCloud.from_numpy(corridor[:sz.map_2m], capacity=sz.map_2m)}
        out["stream"], out["stream_err"] = one_map("scan to the 2M map", gmap2,
                                                   params(sz.crop_2m), sz.s2m_reps)
        del gmap2

    if want_16m:
        gmap16 = {"map": PointCloud.from_numpy(corridor, capacity=corridor.shape[0])}
        out["16m"], out["16m_err"] = one_map("scan to the 16M map", gmap16,
                                             params(sz.crop_16m), sz.s2m_16m_reps)
        del gmap16
        out["cpp_16m"] = cpp.icp(corridor, lx, "s2m16", sz.cpp_reps[2], guess=guess)
    return out


def odometry(sz, device, cpp):
    """bench.py:565-828: the map-building odometry loop, its offline mode,
    the fleet and the C++ run on the same frames."""
    odo = {}
    if os.environ.get("MP2P_BENCH_ODOMETRY", "1") != "1":
        return odo
    n_frames = int(os.environ.get("MP2P_BENCH_ODO_FRAMES", sz.odo_frames))
    gt_o, twists, scans = make_street_sequence(n_frames, n_rings=sz.odo_rings,
                                               n_azimuth=sz.odo_azimuths, dt=ODO_DT)
    frames = odometry_frames(scans, capacity=(1 << 16) // sz.odo_scale)
    mapper = odometry_mapper(os.environ.get("MP2P_ODO_INC_MAP", "1") == "1",
                             os.environ.get("MP2P_ODO_DEC_BACKEND", "sort"), sz.odo_scale)
    p0 = convert.pose_from_numpy(gt_o[0, :3, :3], gt_o[0, :3, 3])
    kw = {"twists": twists, "dt": ODO_DT, "initial_pose": p0}

    def best(label, run):
        """sz.odo_warmups warm-up runs, then the best of sz.odo_runs runs."""
        for _ in range(sz.odo_warmups):
            run()
        runs = []
        for i in range(sz.odo_runs):
            sync(device)
            runs.append(run())
            log(f"[bench] {label} run {i}: {runs[-1]['scans_per_s']:.3f} scans/s")
        return max(runs, key=lambda r: r["scans_per_s"])

    r = best("odometry", lambda: mapper.run(frames, **kw))
    odo["odometry_loop_scans_per_s"] = round(r["scans_per_s"], 2)
    odo["odometry_ate_m"] = round(float(ate_rmse(r["poses"], gt_o)), 4)
    odo["odometry_map_points"] = int(r["map"].count)
    if odo["odometry_ate_m"] >= ATE_LIMIT:
        odo["odometry_loop_scans_per_s"] = 0.0

    r_off = best("odometry offline", lambda: mapper.run_offline(frames, **kw))
    odo["odometry_offline_scans_per_s"] = round(r_off["scans_per_s"], 2)
    odo["odometry_offline_ate_m"] = round(float(ate_rmse(r_off["poses"], gt_o)), 4)
    if odo["odometry_offline_ate_m"] >= ATE_LIMIT:
        odo["odometry_offline_scans_per_s"] = 0.0

    odo_b = int(os.environ.get("MP2P_BENCH_ODO_B", sz.odo_batch))
    if odo_b > 1 and n_frames >= odo_b + 8:
        nb = n_frames - odo_b * 2  # overlapping slices, stream b from frame 2 b
        offs = [2 * b for b in range(odo_b)]
        bm = BatchedOdometryMapper(mapper)
        p0s = [convert.pose_from_numpy(gt_o[o, :3, :3], gt_o[o, :3, 3]) for o in offs]
        r_b = best(f"fleet B={odo_b}", lambda: bm.run_offline(
            [frames[o:o + nb] for o in offs], twists=[twists[o:o + nb] for o in offs],
            initial_poses=p0s, dt=ODO_DT))
        ate_b = max(float(ate_rmse(r_b["poses"][b], gt_o[o:o + nb])) for b, o in enumerate(offs))
        odo["odometry_batched_scans_per_s"] = round(r_b["scans_per_s"], 2)
        odo["odometry_batched_B"] = odo_b
        odo["odometry_batched_max_ate_m"] = round(ate_b, 4)
        if ate_b >= ATE_LIMIT:
            odo["odometry_batched_scans_per_s"] = 0.0

    res = cpp.odometry(frames, twists, ODO_DT)
    cpp_speed = float(res[0]["scans_per_s"]) if res else None
    odo["odometry_cpp_scans_per_s"] = round(cpp_speed, 3) if res else None
    odo["odometry_cpp_ate_m"] = None
    if res:
        full = np.tile(np.eye(4), (res[1].shape[0], 1, 1))
        full[:, :3, :] = res[1]  # relative to frame 0, as the C++ writes them
        odo["odometry_cpp_ate_m"] = round(float(ate_rmse(full, np.linalg.inv(gt_o[0]) @ gt_o)), 4)
    odo["odometry_vs_baseline"] = (round(odo["odometry_loop_scans_per_s"] / cpp_speed, 2)
                                   if cpp_speed else None)
    odo["odometry_batched_vs_baseline"] = (
        round(odo["odometry_batched_scans_per_s"] / cpp_speed, 2)
        if cpp_speed and "odometry_batched_scans_per_s" in odo else None)
    return odo


def diverged(extra):
    """The errors of the line at or above their limits."""
    errs = ("pose_err_se3_log", "batched_max_err", "scan2map_err", "scan2map_batched_max_err",
            "scan2map_streamed_err", "scan2map_16M_err")
    ates = ("odometry_ate_m", "odometry_offline_ate_m", "odometry_batched_max_ate_m")
    return ([k for k in errs if extra[k] >= ERR_LIMIT]
            + [k for k in ates if extra.get(k) is not None and extra[k] >= ATE_LIMIT])


def rounded(x, digits):
    return None if x is None else round(float(x), digits)


def ratio(a, b):
    return round(a / float(b), 2) if b else None


def bench(sz, device):
    """Every section; returns the line's dict."""
    if device.type == "cuda":
        name, limit = card()
        t0 = time.perf_counter()
        cuda_build.build()
        log(f"[bench] kernels built or loaded in {time.perf_counter() - t0:.1f} s")
    else:
        name, limit = host_cpu(), None
    log(f"[bench] host CPU (the C++ baselines): {host_cpu()}")
    cuda_build.reset_launches()
    with tempfile.TemporaryDirectory(prefix="mp2p_bench_") as tmp:
        cpp = NativeBaselines(tmp)
        s = scan_to_scan(sz, device, cpp)
        B, batched, err_b = batch_of_pairs(sz, device, s)
        profile = os.environ.get("MP2P_BENCH_PROFILE", "1") == "1"
        stage = stage_profile(sz, device, s) if profile else {}
        m = scan_to_map(sz, device, cpp)
        odo = odometry(sz, device, cpp)
    log(f"[bench] launches {json.dumps(cuda_build.launches)}")
    c, cm, c16 = s["cpp"], m["cpp"], m["cpp_16m"]
    cpp_speed = float(c["aligns_per_s"]) if c else None
    best = max(s["scans_per_s"], batched)
    extra = {
        "sequential_scans_per_s": round(s["scans_per_s"], 2),
        "batched_scans_per_s": round(batched, 2),
        "batch_size": B,
        "scan2map_1M_scans_per_s": round(m["s2m"], 2),
        "scan2map_err": round(m["s2m_err"], 5),
        "scan2map_batched_scans_per_s": round(m["b"], 2),
        "scan2map_batched_B": m["B"],
        "scan2map_batched_max_err": round(m["b_err"], 5),
        "scan2map_streamed_scans_per_s": round(m["stream"], 2),
        "scan2map_streamed_err": round(m["stream_err"], 5),
        "scan2map_16M_scans_per_s": round(m["16m"], 2),
        "scan2map_16M_err": round(m["16m_err"], 5),
        "scan2map_16M_cpp_aligns_per_s": rounded(c16 and c16["aligns_per_s"], 4),
        "scan2map_16M_cpp_tree_build_s": rounded(c16 and c16["tree_build_s"], 3),
        "stage_profile_ms": stage or None,
        "scan2map_cpp_aligns_per_s": rounded(cm and cm["aligns_per_s"], 3),
        "scan2map_cpp_aligns_per_s_tree_cached": rounded(cm and cm["aligns_per_s_cached"], 3),
        "scan2map_cpp_tree_build_s": rounded(cm and cm["tree_build_s"], 3),
        "scan2map_vs_baseline": ratio(m["s2m"], cm and cm["aligns_per_s"]),
        "scan2map_batched_vs_baseline": ratio(m["b"], cm and cm["aligns_per_s"]),
        **odo,
        "cpp_kdtree_icp_aligns_per_s": cpp_speed,
        "cpp_iters": int(c["iters"]) if c else None,
        "pose_err_se3_log": round(s["err"], 5),
        "batched_max_err": round(err_b, 5),
        "n_points": sz.n_points,
        "iters": s["iters"],
        "backend": device.type,
        "device": name,
        "power_limit_w": limit,
    }
    return {"metric": METRIC, "value": round(best, 2), "unit": "scans/s",
            "vs_baseline": ratio(best, cpp_speed), "extra": extra}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the port runs (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes, for the CPU test (not a measurement)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run bench_torch.py on a GPU, or pass --device cpu")
    set_default_device(device)
    stdout = sys.stdout
    # the line is the only output on stdout; anything else printed goes to stderr
    with contextlib.redirect_stdout(sys.stderr):
        line = bench(SMOKE if args.smoke else FULL, device)
    print(json.dumps(line), file=stdout, flush=True)
    bad = diverged(line["extra"])
    if bad:
        log(f"[bench] diverged: {', '.join(f'{k} = {line['extra'][k]}' for k in bad)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
