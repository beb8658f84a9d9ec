#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end, and check it.

    python3 chip_smoke.py [--profile]

Phases (each prints its lines; any failure raises and exits non-zero):

1. name the card (nvidia-smi name and power limit); no CUDA -> fail;
2. build the CUDA kernels from mp2p_icp_tpu_torch/csrc with nvcc;
3. hold the kNN kernel against its plain PyTorch version on the card:
   two 8192-point street scans for k=1 and k=8, and a ragged 777x3001 case
   with invalid rows and a per-query radius, compared tie-tolerantly;
   median times of kernel and plain version by CUDA events;
4. the main path: ICP.align with the KITTI scan-to-scan configuration on
   the bench street pair at 8192 points, then 8 further pairs served one
   after another; each SE(3) error must be < 0.1 and the kernel's launch
   count must equal the number of matcher calls; one pair is also aligned
   on the CPU (plain path) and its pose compared with the GPU's;
5. with --profile only: where a warm align's time goes (torch.profiler
   over 2 aligns, then per-section host times with a sync around each
   section); the profiler's table goes to chiprun_out/profile_tables.txt;
6. one JSON line with the kernels' numbers, then the last line
   {"ok": true, "device": {...}}.

Imports torch, numpy, the port and bench.py's scene generator (numpy
only); never jax.
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import bench
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters
from mp2p_icp_tpu_torch.matchers import MatcherAdaptive, MatcherPointsDistanceThreshold
from mp2p_icp_tpu_torch.ops import cuda_build
from mp2p_icp_tpu_torch.ops import nn_bruteforce as nnb
from mp2p_icp_tpu_torch.parity import knn_mismatch
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.robust import RobustKernel
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn

N_POINTS = 8192  # the bench pair: a decimated KITTI scan
N_REQUESTS = 8
GT = (1.1, 0.05, 0.01, 0.01, 0.002, 0.001)
ERR_LIMIT = 0.1  # the reference's end-to-end bound on ||log(gt^-1 T)||
KERNEL_SOURCE = "mp2p_icp_tpu_torch/csrc/knn_bruteforce.cu"
REPLACES = "mp2p_icp_tpu/ops/nn_bruteforce.py:154"  # _nnk_kernel_gridless


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


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


def street_pair(scene, seed_g, seed_l, device):
    """(local layers, global layers) of one bench pair on ``device``."""
    g = bench.sample_scan(scene, np.random.RandomState(seed_g), n=N_POINTS)
    loc = bench.sample_scan(scene, np.random.RandomState(seed_l), n=N_POINTS)
    gt = se3.from_xyz_ypr(*GT)
    loc = se3.apply(se3.inverse(gt), torch.from_numpy(loc)).numpy()
    return ({"raw": PointCloud.from_numpy(loc, device=device)},
            {"raw": PointCloud.from_numpy(g, device=device)})


def matcher_calls(icp, n_iterations):
    """kNN sweeps the ICP loop ran: one per active matcher and layer pair
    on each iteration (the paired-ratio quality reuses the ICP pairings)."""
    return sum(
        len(m.layer_matches)
        for it in range(n_iterations) for m in icp.matchers if m.gate(it) > 0
    )


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare_sweep(q, p, k, label):
    """Kernel vs knn_plain on the same card tensors; returns max |Δd²|."""
    d, i = nnb.knn_sweep(q, p, k)
    d_ref, i_ref = nnb.knn_plain(q, p, k)
    torch.cuda.synchronize()
    d, i, d_ref, i_ref = (x.cpu().numpy() for x in (d, i, d_ref, i_ref))
    ok = np.isfinite(d_ref)
    check((np.isfinite(d) == ok).all(), f"{label}: filled slots differ")
    bad = knn_mismatch(q.cpu().numpy(), p.cpu().numpy(), i, ok, i_ref, d_ref, ok)
    check(not bad.any(), f"{label}: {bad.sum()} entries disagree beyond ties")
    err = float(np.abs(d[ok] - d_ref[ok]).max()) if ok.any() else 0.0
    # both round (q-p)^2 per product and per sum in the same order: bit for bit
    check(err == 0.0, f"{label}: max |d2 - d2_plain| = {err} m^2, not 0")
    same_idx = float((i == i_ref).mean())
    print(f"[kernel] {label}: ok, max |d2 - d2_plain| = {err:.3g} m^2 (must be 0), "
          f"same index {same_idx:.6f} (indices tie-tolerant 2e-3 m^2)")
    return err


def timed_aligns(icp, loc, glob, params, n):
    """n synchronised aligns; returns (host-clock seconds of each, last result)."""
    dev = loc["raw"].xyz.device
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = icp.align(loc, glob, se3.identity(device=dev), params)
        float(res.optimal_tf.t[0])  # syncs
        walls.append(time.perf_counter() - t0)
    return walls, res


def profile_align(icp, loc, glob, params, smi):
    """Where a warm align's time goes: torch.profiler over 2 aligns (device
    busy share, launch/copy/sync counts), then the sections' host times with
    a sync around each (which adds its own cost)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mp2p_icp_tpu_torch import icp as icp_mod
    from mp2p_icp_tpu_torch.matchers import adaptive, distance_threshold
    from mp2p_icp_tpu_torch.solvers import gauss_newton, horn, solver

    walls, res = timed_aligns(icp, loc, glob, params, 2)
    print(f"[profile] warm aligns {[round(w * 1e3, 1) for w in walls]} ms, "
          f"{res.n_iterations} iterations, on {smi}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        walls, _ = timed_aligns(icp, loc, glob, params, 2)
    wall_ms = sum(walls) * 1e3
    ka = prof.key_averages()
    # kernel rows only: an op row's self device time repeats its kernels'
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA) / 1e3
    n_kernels = sum(e.count for e in ka if e.device_type == DeviceType.CUDA)
    print(f"[profile] 2 aligns under torch.profiler: wall {wall_ms:.1f} ms, device "
          f"kernel time {dev_ms:.3f} ms ({n_kernels} kernels), busy "
          f"{dev_ms / wall_ms:.4f}, idle {1 - dev_ms / wall_ms:.4f}")
    for e in ka:
        if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync",
                     "cudaStreamSynchronize", "cudaDeviceSynchronize"):
            print(f"[profile]   {e.key}: {e.count} calls, "
                  f"host {e.self_cpu_time_total / 1e3:.2f} ms")
        if e.device_type == DeviceType.CUDA and "knn_sweep_kernel" in e.key:
            print(f"[profile]   knn kernel: {e.count} launches, "
                  f"{e.self_device_time_total / 1e3:.3f} ms")
    out = pathlib.Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "profile_tables.txt").write_text(
        ka.table(sort_by="self_cpu_time_total", row_limit=40) + "\n\n"
        + ka.table(sort_by="self_device_time_total", row_limit=20))

    sections = {}
    wrapped = [
        (distance_threshold, "knn_bruteforce", "knn (DistanceThreshold)"),
        (adaptive, "knn_bruteforce", "knn (Adaptive)"),
        (distance_threshold, "resolve_one_to_one", "one-to-one"),
        (adaptive, "adaptive_threshold_sq", "adaptive threshold"),
        (icp_mod.ICP, "_run_matchers", "matchers total"),
        (solver.SolverHorn, "solve", "Horn solve"),
        (solver.SolverGaussNewton, "solve", "GN solve"),
        (gauss_newton, "gn_build_normal_equations", "GN normal equations"),
        (gauss_newton, "solve_normal_equations", "GN Cholesky solve"),
        (horn, "max_eigvec_4x4", "Horn power iteration"),
        (se3, "delta_norms", "termination delta_norms"),
        (icp_mod, "compute_covariance", "covariance"),
        (icp_mod.ICP, "_quality_stack", "quality"),
    ]

    def synced(f, label):
        def g(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = f(*a, **kw)
            torch.cuda.synchronize()
            sections[label] = sections.get(label, 0.0) + time.perf_counter() - t0
            return r
        return g

    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in wrapped]
    try:
        for (owner, name, label), (_, _, f) in zip(wrapped, saved):
            setattr(owner, name, synced(f, label))
        walls, _ = timed_aligns(icp, loc, glob, params, 3)
    finally:
        for owner, name, f in saved:
            setattr(owner, name, f)
    print(f"[profile] sectioned aligns {[round(w * 1e3, 1) for w in walls]} ms "
          f"(a sync around each section)")
    for label, secs in sorted(sections.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {label:26s} {secs / 3 * 1e3:8.2f} ms per align")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile a warm align (phase 5)")
    args = ap.parse_args()

    # ---- 1. the card
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {kind}")

    # ---- 2. build
    t0 = time.perf_counter()
    nnb.load_kernel()
    rec = cuda_build.build_record("knn_bruteforce")
    print(f"[build] {KERNEL_SOURCE} -> {rec['path']} for sm_90a: "
          f"{'compiled' if rec['built'] else 'cached'} in {rec['seconds']:.1f} s "
          f"(load {time.perf_counter() - t0:.1f} s)")
    for line in rec["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}")

    # ---- 3. kernel against the plain version
    scene = bench.make_scene(np.random.RandomState(0))
    loc, glob = street_pair(scene, 1, 2, dev)
    q = loc["raw"].xyz.contiguous()
    p = glob["raw"].xyz.contiguous()
    errs = [compare_sweep(q, p, k, f"{N_POINTS}x{N_POINTS} k={k}") for k in (1, 8)]

    rng = np.random.RandomState(7)
    qr = torch.from_numpy(rng.uniform(-60, 60, (777, 3)).astype(np.float32))
    pr = torch.from_numpy(rng.uniform(-60, 60, (3001, 3)).astype(np.float32))
    qv = torch.from_numpy(rng.rand(777) > 0.1)
    pv = torch.from_numpy(rng.rand(3001) > 0.1)
    rad = torch.from_numpy(rng.uniform(1.0, 400.0, 777).astype(np.float32))
    qs = torch.where(qv[:, None], qr, 1.0e8).to(dev)  # the front end's sentinels
    ps = torch.where(pv[:, None], pr, -1.0e8).to(dev)
    errs.append(compare_sweep(qs, ps, 4, "777x3001 k=4 invalid rows"))
    res_gpu = nnb.knn_bruteforce(qr.to(dev), qv.to(dev), pr.to(dev), pv.to(dev), k=4,
                                 max_radius_sq=rad.to(dev))
    res_cpu = nnb.knn_bruteforce(qr, qv, pr, pv, k=4, max_radius_sq=rad)
    bad = knn_mismatch(qr.numpy(), pr.numpy(), res_gpu.idx.cpu().numpy(),
                       res_gpu.valid.cpu().numpy(), res_cpu.idx.numpy(),
                       res_cpu.dist_sq.numpy(), res_cpu.valid.numpy(),
                       radius_sq=rad.numpy())
    check(not bad.any(), f"777x3001 front end with radius: {bad.sum()} entries differ")
    print(f"[kernel] 777x3001 k=4 front end, invalid rows + per-query radius: ok "
          f"({int(res_gpu.valid.sum())} valid pairs, same as the CPU plain path: "
          f"{torch.equal(res_gpu.valid.cpu(), res_cpu.valid)})")
    torch.cuda.synchronize()

    times = {}
    for k in (1, 8):
        times[k] = (cuda_ms(lambda: nnb.knn_sweep(q, p, k)),
                    cuda_ms(lambda: nnb.knn_plain(q, p, k), reps=5))
        print(f"[time] knn {N_POINTS}x{N_POINTS} k={k}: kernel {times[k][0]:.4f} ms, "
              f"knn_plain {times[k][1]:.4f} ms (median, CUDA events) on {smi}")

    # ---- 4. the main path
    icp = kitti_icp()
    params = ICPParameters(max_iterations=40)
    gt = se3.from_xyz_ypr(*GT, device=dev)
    requests = [(1, 2)] + [(100 + 2 * b, 101 + 2 * b) for b in range(N_REQUESTS)]
    pairs = [street_pair(scene, sg, sl, dev) for sg, sl in requests]
    torch.cuda.synchronize()
    nnb.knn_sweep.launches = 0
    expected = 0
    results, wall = [], []
    for loc_l, glob_l in pairs:
        t0 = time.perf_counter()
        res = icp.align(loc_l, glob_l, se3.identity(device=dev), params)
        err = float(se3.error_log_norm(gt, res.optimal_tf))  # syncs
        wall.append(time.perf_counter() - t0)
        results.append((res, err))
        expected += matcher_calls(icp, res.n_iterations)
    launches = nnb.knn_sweep.launches
    check(launches == expected and launches > 0,
          f"kernel launches {launches} != matcher calls {expected}")

    res, err = results[0]
    print(f"[align] KITTI config, bench pair {N_POINTS} pts on {kind}: SE(3) error "
          f"{err:.6f}, {res.n_iterations} iterations, {res.termination_reason.name}, "
          f"quality {float(res.quality):.6f}, {wall[0] * 1e3:.1f} ms (first call) "
          f"[JAX CPU reference: 0.00222, 12, STALLED, 0.872]")
    check(err < ERR_LIMIT, f"SE(3) error {err} >= {ERR_LIMIT}")
    for b, ((r, e), w) in enumerate(zip(results[1:], wall[1:])):
        print(f"[serve] pair {b}: error {e:.6f}, {r.n_iterations} iterations, "
              f"{r.termination_reason.name}, {w * 1e3:.1f} ms")
        check(e < ERR_LIMIT, f"pair {b}: SE(3) error {e} >= {ERR_LIMIT}")
    serve_s = sum(wall[1:])
    median_ms = statistics.median(wall[1:]) * 1e3
    print(f"[serve] {N_REQUESTS} pairs in {serve_s:.3f} s: "
          f"{N_REQUESTS / serve_s:.2f} aligns/s, median {median_ms:.1f} ms/align on {smi}")
    print(f"[count] knn kernel launches {launches} == matcher calls {expected}")

    loc_c = {"raw": PointCloud(loc["raw"].xyz.cpu(), loc["raw"].count.cpu())}
    glob_c = {"raw": PointCloud(glob["raw"].xyz.cpu(), glob["raw"].count.cpu())}
    t0 = time.perf_counter()
    res_c = icp.align(loc_c, glob_c, se3.identity(), params)
    cpu_s = time.perf_counter() - t0
    gap = float(se3.error_log_norm(
        se3.Pose(res_c.optimal_tf.R.to(dev), res_c.optimal_tf.t.to(dev)), res.optimal_tf))
    print(f"[cpu] same pair on the CPU plain path: {res_c.n_iterations} iterations, "
          f"{res_c.termination_reason.name}, pose gap to the GPU result {gap:.3g} "
          f"({cpu_s:.1f} s)")
    check(gap < 5e-3, f"CPU/GPU pose gap {gap}")

    # ---- 5. profile (optional)
    if args.profile:
        profile_align(icp, loc, glob, params, smi)

    # ---- 6. results
    print(json.dumps({"kernels": [{
        "name": "knn_sweep",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": times[1][0],
        "plain_ms": times[1][1],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
