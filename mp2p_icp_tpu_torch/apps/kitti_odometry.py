"""kitti-odometry: LiDAR odometry over a KITTI sequence of .bin scans.

Port of ``mp2p_icp_tpu/apps/kitti_odometry.py``. In place of the
reference's batch procedure (scripts/kitti-run-seq.py runs ``icp-run`` on
each consecutive pair with demos/icp-settings-kitti.yaml), the scans stream
through the YAML's filter pipeline and the ICP engine in one process:

- sequential: each pair is aligned from a constant-velocity guess (the
  previous relative pose); the chain of poses stays on the device;
- batched (``-B``): B consecutive pairs are aligned in one
  ``make_batched_align`` call (the batched kNN kernel serves all of them),
  each seeded with the previous batch's last relative pose; the host reads
  the poses once per batch and only frames [s, s+B] are resident;
- ``--mapping``: scan-to-map odometry with ``OdometryMapper``, the
  matchers re-pointed at the rolling map layer, a FirstPoint voxel filter
  maintaining it; with ``--loop-closure``, then revisit detection,
  ICP-verified loop edges and the pose graph over the trajectory
  (``loop_closure.py``).

The trajectory is evaluated against ground truth (ATE / RPE) and saved in
KITTI pose format.

Usage:
  python -m mp2p_icp_tpu_torch.apps.kitti_odometry \\
      --bin-dir KITTI/sequences/00/velodyne -c icp-settings-kitti.yaml \\
      [--gt-poses 00.txt] [--max-frames N] [--out-poses est.txt] [-B 8] \\
      [--mapping [--map-capacity N] [--out-map map.mm.npz] [--loop-closure]]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import sys
import time

import numpy as np

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device

def sequence_capacity(scan_paths) -> int:
    """One capacity for the whole sequence, from its largest scan (16 bytes
    a point), so that no later scan outgrows the shapes of the first."""
    from mp2p_icp_tpu_torch.core.pointcloud import round_capacity

    return round_capacity(max(max(os.path.getsize(str(p)) // 16 for p in scan_paths), 1))


def torch_from(a: np.ndarray, device):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _evaluate(out, gt_poses):
    from mp2p_icp_tpu_torch.eval.trajectory import ate_rmse, rpe

    if gt_poses is not None:
        gt = np.asarray(gt_poses)[: len(out["poses"])]
        out["ate_rmse"] = ate_rmse(out["poses"], gt)
        out["rpe_trans"], out["rpe_rot"] = rpe(out["poses"], gt)
    return out


def run_sequence(scan_paths, config_path: str, gt_poses=None, max_frames=None, verbose=True,
                 batch_size: int = 0, device=None):
    """Scan-to-scan odometry over ``scan_paths`` on ``device`` (default: the
    package's default device). ``batch_size`` > 0: B pairs per batched
    align, every pair of batch k seeded with batch k-1's last relative pose
    (one host read per batch).

    Returns {"poses" [N, 4, 4], "scans_per_s", "n_frames", "iterations"
    (per align), "batch_iterations" (batched: the slowest pair of each
    batch, which the batched loop runs for)} and, with ``gt_poses``,
    "ate_rmse", "rpe_trans", "rpe_rot"."""
    from mp2p_icp_tpu_torch.core import se3
    from mp2p_icp_tpu_torch.device import resolve
    from mp2p_icp_tpu_torch.eval.trajectory import poses_from_se3
    from mp2p_icp_tpu_torch.filters import apply_filter_pipeline
    from mp2p_icp_tpu_torch.io.kitti import load_kitti_bin
    from mp2p_icp_tpu_torch.pipeline import load_icp_config_file

    device = resolve(device)
    icp, params, sections = load_icp_config_file(config_path)
    filters = sections.get("filters", [])
    if max_frames:
        scan_paths = scan_paths[:max_frames]
    cap = sequence_capacity(scan_paths)

    def prep(path):
        return apply_filter_pipeline(filters, {"raw": load_kitti_bin(str(path), capacity=cap,
                                                                      device=device)})

    ident = se3.identity(device=device)
    iterations, batch_iterations = [], []
    if batch_size > 0:
        from mp2p_icp_tpu_torch.parallel import make_batched_align, stack_pytrees

        B = batch_size
        fb = make_batched_align(icp, params)
        rel_R, rel_t = [], []
        n_pairs = len(scan_paths) - 1
        # frame i is the local side of pair i-1 and the global side of pair
        # i: only frames [s, s+B] need be resident
        window = {}

        def frame(i):
            if i not in window:
                window[i] = prep(scan_paths[i])
            return window[i]

        t0 = time.perf_counter()
        guess = ident
        for s in range(0, n_pairs, B):
            idx = list(range(s, min(s + B, n_pairs)))
            pad = idx + [idx[-1]] * (B - len(idx))  # a fixed batch shape
            rb = fb(stack_pytrees([frame(i + 1) for i in pad]),
                    stack_pytrees([frame(i) for i in pad]), stack_pytrees([guess] * B))
            # one host read per batch: the poses and iterations of the pairs
            R_np, t_np = rb.optimal_tf.R.cpu().numpy(), rb.optimal_tf.t.cpu().numpy()
            its = rb.n_iterations.cpu().numpy()
            del rb
            rel_R.append(R_np[: len(idx)])
            rel_t.append(t_np[: len(idx)])
            iterations += its[: len(idx)].tolist()
            batch_iterations.append(int(its.max()))
            last = len(idx) - 1
            guess = se3.Pose(torch_from(R_np[last], device), torch_from(t_np[last], device))
            for i in list(window):  # frames behind the window
                if i <= s + B - 1:
                    del window[i]
        t_align = time.perf_counter() - t0
        n_align = n_pairs
        traj = [ident]
        for R, t in zip(rel_R, rel_t):
            for k in range(R.shape[0]):
                traj.append(se3.compose(traj[-1], se3.Pose(torch_from(R[k], device),
                                                           torch_from(t[k], device))))
        if verbose:
            print(f"[kitti-odometry] batched B={B}: {n_align / max(t_align, 1e-9):.2f} scans/s",
                  flush=True)
    else:
        traj = [ident]
        rel_prev = ident
        prev_layers = prep(scan_paths[0])
        n_align = 0
        t0 = time.perf_counter()
        for i, path in enumerate(scan_paths[1:], start=1):
            cur_layers = prep(path)
            res = icp.align(cur_layers, prev_layers, rel_prev, params)  # constant velocity
            traj.append(se3.compose(traj[-1], res.optimal_tf))
            rel_prev = res.optimal_tf
            prev_layers = cur_layers
            iterations.append(res.n_iterations)
            n_align += 1
            if verbose and i % 50 == 0:
                print(f"[kitti-odometry] {i}/{len(scan_paths) - 1} "
                      f"({n_align / max(time.perf_counter() - t0, 1e-9):.2f} scans/s)", flush=True)
        float(traj[-1].t[0])  # the fetch waits for every align
        t_align = time.perf_counter() - t0

    out = {"poses": poses_from_se3(traj), "scans_per_s": n_align / max(t_align, 1e-9),
           "n_frames": len(traj), "iterations": np.asarray(iterations, np.int64),
           "batch_iterations": np.asarray(batch_iterations, np.int64)}
    return _evaluate(out, gt_poses)


def run_sequence_mapping(scan_paths, config_path: str, gt_poses=None, max_frames=None,
                         map_layer: str = "map", map_capacity: int = 1 << 20,
                         map_voxel: float = 0.5, merge_every: int = 1,
                         loop_closure: bool = False, loop_min_gap: int = 20,
                         loop_max_distance: float = 5.0, verbose=True, device=None):
    """Scan-to-map odometry (the mola_lidar_odometry loop): per frame the
    YAML's filter pipeline, an align against the rolling map on the device
    and the merge into it (``OdometryMapper`` of the port). The config's
    matchers are re-pointed at ``map_layer`` on the global side; a
    FilterDecimateVoxels (FirstPoint, ``map_voxel``) maintains the map.

    ``loop_closure``: after the run, loop closure over the trajectory
    (candidates at least ``loop_min_gap`` frames apart and within
    ``loop_max_distance`` m, verified scan to scan with the YAML's own
    modules, reloaded); "poses" are then the corrected ones, "poses_odometry" the
    run's, "loop_closures" the accepted (i, j, quality).

    Returns OdometryMapper.run's dict ("poses", "map", "iterations" per
    frame, ...) with "n_frames" and, with ``gt_poses``, "ate_rmse",
    "rpe_trans", "rpe_rot"."""
    from mp2p_icp_tpu_torch.device import resolve
    from mp2p_icp_tpu_torch.filters.decimate_voxels import FilterDecimateVoxels
    from mp2p_icp_tpu_torch.io.kitti import load_kitti_bin
    from mp2p_icp_tpu_torch.odometry import OdometryMapper
    from mp2p_icp_tpu_torch.pipeline import load_icp_config_file

    device = resolve(device)
    icp, params, sections = load_icp_config_file(config_path)
    if max_frames:
        scan_paths = scan_paths[:max_frames]
    cap = sequence_capacity(scan_paths)
    # the matchers keep their local layer; the global side becomes the map
    local_layer = icp.matchers[0].layer_matches[0].local_layer
    icp.matchers = [
        dataclasses.replace(m, layer_matches=tuple(
            dataclasses.replace(lm, global_layer=map_layer) for lm in m.layer_matches))
        for m in icp.matchers
    ]
    mapper = OdometryMapper(
        icp=icp, params=params, filters=sections.get("filters", []),
        local_layer=local_layer, map_layer=map_layer, map_capacity=map_capacity,
        merge_every=merge_every,
        map_filters=[FilterDecimateVoxels(
            input_pointcloud_layer=(map_layer,), output_pointcloud_layer=map_layer,
            voxel_filter_resolution=map_voxel, output_capacity=map_capacity)],
    )
    frames = [{"raw": load_kitti_bin(str(p), capacity=cap, device=device)} for p in scan_paths]
    out = mapper.run(frames, progress_every=50 if verbose else 0)
    out["n_frames"] = len(frames)
    if loop_closure:
        from mp2p_icp_tpu_torch.filters import apply_filter_pipeline
        from mp2p_icp_tpu_torch.loop_closure import close_and_optimize

        # the scan-to-scan aligns of the closure take the YAML's own layer
        # topology: reload it
        icp_lc, params_lc, _ = load_icp_config_file(config_path)

        class _Filtered:  # a frame's filtered cloud, made when a candidate reads it
            def __getitem__(self, k):
                return apply_filter_pipeline(mapper.filters, dict(frames[k]))[local_layer]

        lc = close_and_optimize(icp_lc, params_lc, _Filtered(), out["poses"],
                                min_frame_gap=loop_min_gap, max_distance=loop_max_distance,
                                layer=icp_lc.matchers[0].layer_matches[0].global_layer)
        if verbose:
            print(f"[loop-closure] candidates={lc['n_candidates']} accepted={lc['n_accepted']}")
        out["poses_odometry"] = out["poses"]
        out["poses"] = lc["poses"]
        out["loop_closures"] = lc["loops"]
    return _evaluate(out, gt_poses)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kitti-odometry")
    ap.add_argument("--bin-dir", required=True)
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--gt-poses", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--out-poses", default=None)
    ap.add_argument("-B", "--batch-size", type=int, default=0,
                    help="align consecutive pairs in batches of B instead of one by one; "
                         "every pair of a batch is seeded with the previous batch's last "
                         "relative pose")
    ap.add_argument("--mapping", action="store_true",
                    help="scan-to-map odometry against a rolling map on the device instead "
                         "of scan-to-scan pairs")
    ap.add_argument("--map-voxel", type=float, default=0.5,
                    help="map-maintenance voxel size [m] (mapping mode)")
    ap.add_argument("--map-capacity", type=int, default=1 << 20)
    ap.add_argument("--merge-every", type=int, default=1,
                    help="merge every k-th frame into the map (keyframing)")
    ap.add_argument("--out-map", default=None,
                    help="save the final map as .mm.npz (mapping mode)")
    ap.add_argument("--loop-closure", action="store_true",
                    help="after the mapping run: revisit detection, ICP-verified loop edges "
                         "and pose-graph Gauss-Newton over the trajectory (mapping mode)")
    ap.add_argument("--loop-min-gap", type=int, default=20,
                    help="minimum frame separation for a loop candidate")
    ap.add_argument("--loop-max-distance", type=float, default=5.0,
                    help="maximum revisit distance [m] for a candidate")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from mp2p_icp_tpu_torch.eval.trajectory import load_kitti_poses, save_kitti_poses

    paths = sorted(pathlib.Path(args.bin_dir).glob("*.bin"))
    if not paths:
        raise SystemExit(f"error: no .bin scans in {args.bin_dir}")
    gt = load_kitti_poses(args.gt_poses) if args.gt_poses else None
    with on_device(args.device) as device:
        if args.mapping:
            out = run_sequence_mapping(
                paths, args.config, gt_poses=gt, max_frames=args.max_frames,
                map_capacity=args.map_capacity, map_voxel=args.map_voxel,
                merge_every=args.merge_every, loop_closure=args.loop_closure,
                loop_min_gap=args.loop_min_gap, loop_max_distance=args.loop_max_distance,
                device=device)
            if args.out_map:
                from mp2p_icp_tpu_torch.core.metric_map import MetricMap
                from mp2p_icp_tpu_torch.io.mm import save_mm_file

                save_mm_file(args.out_map, MetricMap(layers={"map": out["map"]}))
                print(f"map saved to {args.out_map} ({int(out['map'].count)} points)")
        else:
            out = run_sequence(paths, args.config, gt_poses=gt, max_frames=args.max_frames,
                               batch_size=args.batch_size, device=device)
    print(f"frames={out['n_frames']} scans/s={out['scans_per_s']:.2f}"
          + (f" ATE={out['ate_rmse']:.3f}m RPE={out['rpe_trans']:.3f}m/{out['rpe_rot']:.4f}rad"
             if "ate_rmse" in out else ""))
    its = np.asarray(out["iterations"])
    print(f"ICP iterations: {int(its.sum())} over {len(its)} aligns (mean {its.mean():.2f}, "
          f"max {int(its.max())})"
          + (f"; the slowest pair of each batch: {out['batch_iterations'].tolist()}"
             if len(out.get("batch_iterations", ())) else ""))
    if args.out_poses:
        save_kitti_poses(args.out_poses, out["poses"])
        print(f"poses saved to {args.out_poses}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
