#!/usr/bin/env python3
"""The JAX package's results for the apps phase of chip_smoke.py, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_apps_reference.py [--frames N]
        [--rings R --azimuths A] [--map-capacity M] [--port] [--write FILE]

Renders chip_smoke.py's KITTI-format sequence (``chip_smoke.write_apps_sequence``:
the street drive at HDL-64E geometry, .bin scans and gt.txt) and the files
of icp-run and mm-filter (``chip_smoke.write_app_inputs``), feeds the same
bytes to the JAX package's apps and prints one JSON object with the
constants chip_smoke.py holds the port against; ``--write`` also writes it
to a file, and chip_smoke.py reads ``scripts/torch_apps_reference.json``,
written so with the defaults:

- "sequential", "batched" (-B 8), "mapping" (--map-capacity): kitti-odometry's
  poses (KITTI rows), ATE, RPE, ICP iterations (per align; per batch, the
  slowest pair) and scans/s on this CPU, with demos/icp-settings-kitti.yaml;
- "cropped_sequential", "cropped_mapping": the same with
  ``chip_smoke.ground_cropped_yaml`` (the demo's pipeline with the ground
  cropped away ahead of a finer decimation), which tracks the drive;
- "port_cpu": the port's "mapping" and "cropped_mapping" runs on the CPU
  (poses, map points, iterations), with the same trimmed capacities: a
  scan-to-map run amplifies the pairings that the JAX package's
  approximate kNN distances turn, so chip_smoke.py holds the card's
  scan-to-map pairs to these and the JAX package's by its trajectory;
- "icp_run": icp-run on frames 1 (local) and 0 (global), from the .xyz.gz
  files and from the MRPT .mm files, with demos/icp-settings-kitti.yaml;
- "mm_filter": mm-filter with ``chip_smoke.STRUCTURED_YAML`` on frame 0:
  ``chip_smoke.layer_summary`` of each output layer and the planes' count
  and sums;
- "mm_filter_rows": FilterEdgesPlanes' output of that run row for row
  (``chip_smoke.edges_planes_record``: the input rows of edge_points and
  plane_points, the planes' centroids and normals).

One substitution keeps the JAX runs within reach of a CPU: the kitti YAML's
FirstPoint decimation (2 m) keeps the raw capacity of its input (131072
rows for ~500 voxels), so each of the JAX package's kNN sweeps compares
2^34 pairs (~55 s on a CPU). Here the decimated layer's capacity is the
next power of two above the largest voxel count of the sequence (for the
cropped YAML, of its returns above the crop); the padding rows take part
in no pairing, so the poses do not depend on it. ``--port`` also runs the port's apps on the CPU at
their own capacities and prints their results in the same form: at a small
size (``--frames 6 --rings 16 --azimuths 512``) that is the check that the
substitution moves nothing, and a preview of the chip's run.

This script is not part of the port: it imports both packages. JAX runs on
the CPU (set JAX_PLATFORMS=cpu).
"""

import argparse
import contextlib
import dataclasses
import io
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402
import mp2p_icp_tpu_torch  # noqa: E402
from mp2p_icp_tpu_torch.core.pointcloud import round_capacity  # noqa: E402
from mp2p_icp_tpu_torch.eval.trajectory import load_kitti_poses  # noqa: E402

KITTI_YAML = str(chip_smoke.KITTI_YAML)


def printed(fn, argv):
    """What ``fn(argv)`` prints."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def largest_voxel_count(bin_dir, resolution, z_min=-np.inf):
    """The most voxels of ``resolution`` any scan of the sequence occupies
    with its returns above ``z_min`` (sensor frame)."""
    most = 0
    for p in sorted(pathlib.Path(bin_dir).glob("*.bin")):
        xyz = np.fromfile(p, dtype=np.float32).reshape(-1, 4)[:, :3]
        xyz = xyz[xyz[:, 2] >= z_min]
        most = max(most, len(np.unique(np.floor(xyz / np.float32(resolution)), axis=0)))
    return most


@contextlib.contextmanager
def decimation_capacity(capacity, loader=None):
    """A YAML loader's FilterDecimateVoxels (the JAX package's, or the
    ``loader`` module's) built with ``output_capacity`` = capacity where the
    YAML leaves it at the input's."""
    if loader is None:
        from mp2p_icp_tpu.pipeline import yaml_loader as loader

    build = loader._FILTERS["FilterDecimateVoxels"]

    def trimmed(p, variables=None):
        f = build(p, variables)
        return f if f.output_capacity else dataclasses.replace(f, output_capacity=capacity)

    loader._FILTERS["FilterDecimateVoxels"] = trimmed
    try:
        yield
    finally:
        loader._FILTERS["FilterDecimateVoxels"] = build


@contextlib.contextmanager
def recorded_iterations(record):
    """The JAX package's ICP.align and make_batched_align, recording each
    align's iterations (a list per batch) in ``record``."""
    from mp2p_icp_tpu import icp as jicp
    from mp2p_icp_tpu.parallel import batch as jbatch

    align, make = jicp.ICP.align, jbatch.make_batched_align

    def recording_align(self, *a, **kw):
        res = align(self, *a, **kw)
        record.append(int(res.n_iterations))
        return res

    def recording_make(*a, **kw):
        fb = make(*a, **kw)

        def run(*b, **bkw):
            res = fb(*b, **bkw)
            record.append(np.asarray(res.n_iterations).tolist())
            return res

        return run

    jicp.ICP.align, jbatch.make_batched_align = recording_align, recording_make
    try:
        yield
    finally:
        jicp.ICP.align, jbatch.make_batched_align = align, make


def odometry_summary(out, gt, iterations):
    ate, rt, rr = chip_smoke.trajectory_errors(out["poses"], gt)
    res = {"ate_m": ate, "rpe_trans": rt, "rpe_rot": rr, "scans_per_s": out["scans_per_s"],
           "frames": int(out["n_frames"]),
           "poses": np.asarray(out["poses"])[:, :3, :].reshape(-1, 12).tolist()}
    if iterations is not None:
        res["iterations"] = [int(i) for i in iterations]
    if "map" in out:
        res["map_points"] = int(out["map"].count)
    return res


def run_kitti(args, bin_dir, gt_path, files, port, capacity):
    """kitti-odometry's runs on the sequence: the three modes with the demo
    YAML, and the sequential and mapping modes with the ground-cropped one
    (``chip_smoke.ground_cropped_yaml``). ``capacity``: {YAML: the JAX
    side's decimated capacity}."""
    paths = sorted(pathlib.Path(bin_dir).glob("*.bin"))
    gt = load_kitti_poses(str(gt_path))
    if port:
        from mp2p_icp_tpu_torch.apps import kitti_odometry as app
    else:
        from mp2p_icp_tpu.apps import kitti_odometry as app
    batch, mapping = {"batch_size": chip_smoke.APPS_BATCH}, {"map_capacity": args.map_capacity}
    out = {}
    for key, config, kw in (("sequential", KITTI_YAML, {}), ("batched", KITTI_YAML, batch),
                            ("mapping", KITTI_YAML, mapping),
                            ("cropped_sequential", files["cropped"], {}),
                            ("cropped_mapping", files["cropped"], mapping)):
        run = app.run_sequence_mapping if kw is mapping else app.run_sequence
        record = []
        t0 = time.perf_counter()
        with contextlib.ExitStack() as stack:
            if not port:
                stack.enter_context(decimation_capacity(capacity[config]))
                stack.enter_context(recorded_iterations(record))
            r = run(paths, config, verbose=False, **kw)
        if port:
            iterations = r["iterations"]
        elif kw is mapping:
            iterations = None  # the JAX package's mapper runs a frame as one program
        elif kw is batch:
            iterations = [i for b in record for i in b][: len(paths) - 1]
        else:
            iterations = record
        out[key] = odometry_summary(r, gt, iterations)
        if kw is batch:
            out[key]["batch_iterations"] = (np.asarray(r["batch_iterations"]).tolist() if port
                                            else [max(b) for b in record])
        out[key]["seconds"] = time.perf_counter() - t0
        print(f"[reference] {'port' if port else 'jax'} {key}: ATE {out[key]['ate_m']}, "
              f"{out[key]['seconds']:.1f} s", file=sys.stderr, flush=True)
    return out


def run_port_mapping(args, bin_dir, files, capacity):
    """The port's two scan-to-map runs on the CPU, with the decimated
    capacities the JAX side is trimmed to: the poses the card's runs are
    held to pair by pair (the JAX package's approximate kNN distances turn
    a pairing here and there, which a scan-to-map run amplifies)."""
    from mp2p_icp_tpu_torch.apps import kitti_odometry as app
    from mp2p_icp_tpu_torch.pipeline import yaml_loader

    paths = sorted(pathlib.Path(bin_dir).glob("*.bin"))
    out = {}
    for key, config in (("mapping", KITTI_YAML), ("cropped_mapping", files["cropped"])):
        t0 = time.perf_counter()
        with decimation_capacity(capacity[config], yaml_loader):
            r = app.run_sequence_mapping(paths, config, map_capacity=args.map_capacity,
                                         verbose=False, device="cpu")
        out[key] = {"poses": np.asarray(r["poses"])[:, :3, :].reshape(-1, 12).tolist(),
                    "map_points": int(r["map"].count),
                    "iterations": [int(i) for i in r["iterations"]],
                    "seconds": time.perf_counter() - t0}
        print(f"[reference] port on the CPU, {key}: {out[key]['seconds']:.1f} s",
              file=sys.stderr, flush=True)
    return out


def run_icp_run(files, port):
    if port:
        from mp2p_icp_tpu_torch.apps.icp_run import main
    else:
        from mp2p_icp_tpu.apps.icp_run import main
    return {fmt: chip_smoke.icp_run_printed(printed(main, [
        "--input-local", files[f"{fmt}1"], "--input-global", files[f"{fmt}0"],
        "-c", KITTI_YAML])) for fmt in ("xyz", "mm")}


def run_mm_filter(files, out_dir, port):
    out = str(pathlib.Path(out_dir) / ("port" if port else "jax") / "filtered.mm.npz")
    pathlib.Path(out).parent.mkdir(exist_ok=True)
    if port:
        from mp2p_icp_tpu_torch.apps.mm_filter import main
        from mp2p_icp_tpu_torch.io.mm import load_mm_file
    else:
        from mp2p_icp_tpu.apps.mm_filter import main
        from mp2p_icp_tpu.io.mm import load_mm_file
    printed(main, ["-i", files["npz0"], "-o", out, "-p", files["filters"]])
    mm = load_mm_file(out)
    raw = load_mm_file(files["npz0"]).layers["raw"]
    raw_xyz = np.asarray(raw.xyz)[: int(raw.count)]
    return chip_smoke.mm_filter_summary(mm), chip_smoke.edges_planes_record(mm, raw_xyz)


def run_all(args, port):
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        bin_dir, gt_path, scans = chip_smoke.write_apps_sequence(
            tmp, args.frames, args.rings, args.azimuths)
        files = chip_smoke.write_app_inputs(tmp, scans)
        voxels = largest_voxel_count(bin_dir, 2.0)
        # an upper bound of the cropped layer's voxels: a margin below the crop
        cropped_voxels = largest_voxel_count(bin_dir, chip_smoke.CROPPED_RESOLUTION,
                                             chip_smoke.GROUND_CROP_Z - 0.01)
        capacity = {KITTI_YAML: round_capacity(voxels + 1),
                    files["cropped"]: round_capacity(cropped_voxels + 1)}
        results["size"] = {"frames": args.frames, "rings": args.rings,
                           "azimuths": args.azimuths, "map_capacity": args.map_capacity,
                           "raw_capacity": round_capacity(max(
                               int(s["valid"].sum()) for s in scans)),
                           "most_2m_voxels": voxels, "most_cropped_voxels": cropped_voxels,
                           "jax_decimated_capacity": None if port else capacity[KITTI_YAML],
                           "jax_cropped_capacity": None if port else capacity[files["cropped"]]}
        print(f"[reference] inputs in {time.perf_counter() - t0:.1f} s: {results['size']}",
              file=sys.stderr, flush=True)
        results.update(run_kitti(args, bin_dir, gt_path, files, port, capacity))
        if not port:
            results["port_cpu"] = run_port_mapping(args, bin_dir, files, capacity)
        with contextlib.nullcontext() if port else decimation_capacity(capacity[KITTI_YAML]):
            results["icp_run"] = run_icp_run(files, port)
        results["mm_filter"], results["mm_filter_rows"] = run_mm_filter(files, tmp, port)
    return results


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=chip_smoke.APPS_FRAMES)
    ap.add_argument("--rings", type=int, default=chip_smoke.APPS_RINGS)
    ap.add_argument("--azimuths", type=int, default=chip_smoke.APPS_AZIMUTHS)
    ap.add_argument("--map-capacity", type=int, default=chip_smoke.APPS_MAP_CAPACITY)
    ap.add_argument("--port", action="store_true", help="also run the port's apps on the CPU")
    ap.add_argument("--write", help="also write the JAX package's JSON object to this file")
    args = ap.parse_args()

    t0 = time.perf_counter()
    jax_results = run_all(args, port=False)
    jax_results["seconds"] = time.perf_counter() - t0
    print(json.dumps(jax_results))
    if args.write:
        pathlib.Path(args.write).write_text(json.dumps(jax_results, indent=1) + "\n")
    if args.port:
        mp2p_icp_tpu_torch.set_default_device("cpu")
        t0 = time.perf_counter()
        port_results = run_all(args, port=True)
        port_results["seconds"] = time.perf_counter() - t0
        print(json.dumps({"port_cpu": port_results}))


if __name__ == "__main__":
    main()
