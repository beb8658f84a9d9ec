#!/usr/bin/env python3
"""Time the port's command-line paths whose kNN sweeps padded rows on one
NVIDIA GPU, for this tree and for another checkout of the repository, in
one call.

    python3 scripts/torch_apps_compare.py --baseline DIR [--frames N] [--device cpu]

DIR is an unpacked checkout (e.g. ``git archive <commit> | tar -x -C
build/parent``). The script writes one KITTI-format sequence and one
``.rawlog.npz`` of it (``chip_smoke.write_apps_sequence`` /
``write_rawlog``, 64 rings x 2048 azimuths), then runs, in turns for the
baseline, this tree, this tree and the baseline (each in its own process
that imports that tree's package and builds its kernels):

- kitti-odometry with ``demos/icp-settings-kitti.yaml``: sequential, ``-B
  8`` and ``--mapping --map-capacity 2^18``; ms per frame from the app's
  own scans/s (its align loop), the ICP iterations and the kNN launches;
- rawlog-filter with ``chip_smoke.TOOLS_YAML`` (FirstPoint 0.5 m, normals
  k = 8): ms per frame on the host clock around the call.

Every line names the card and its power limit; the poses of the two trees
are compared (max |t| difference per mode). Results: stdout and
``chiprun_out/apps_compare.json``. ``--device cpu`` rehearses the script
with the plain kNN (no time it prints is the card's).
"""

import argparse
import contextlib
import io
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out"
WORK = OUT / "apps_compare"
MODES = {"sequential": [], "batched": ["-B", "8"],
         "mapping": ["--mapping", "--map-capacity", str(1 << 18)]}


def worker(args):
    """In a tree's own process: run the apps and print one JSON line."""
    import torch

    from mp2p_icp_tpu_torch.apps import kitti_odometry, rawlog_filter
    from mp2p_icp_tpu_torch.ops import cuda_build
    from mp2p_icp_tpu_torch.ops import nn_bruteforce as nnb

    on_card = args.device == "cuda"
    if on_card:
        cuda_build.build()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    sweeps = ("knn_sweep", "knn_sweep_streamed", "knn_sweep_batched")
    out = {}
    for mode, extra in MODES.items():
        for name in sweeps:
            getattr(nnb, name).launches = 0
        buf = io.StringIO()
        poses = WORK / f"poses_{mode}_{args.tag}.txt"
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            kitti_odometry.main(["--bin-dir", str(WORK / "sequence" / "velodyne"), "-c",
                                 str(ROOT / "demos" / "icp-settings-kitti.yaml"),
                                 "--out-poses", str(poses), "--device", args.device] + extra)
        sync()
        text = buf.getvalue()
        out[mode] = {"ms_per_frame": 1e3 / float(re.search(r"scans/s=([0-9.]+)", text).group(1)),
                     "seconds": time.perf_counter() - t0,
                     "iterations": int(re.search(r"ICP iterations: (\d+)", text).group(1)),
                     "launches": {n: getattr(nnb, n).launches for n in sweeps},
                     "poses": str(poses)}
    for name in sweeps:
        getattr(nnb, name).launches = 0
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rawlog_filter.main(["-i", str(WORK / "in.rawlog.npz"), "-o",
                            str(WORK / f"out_{args.tag}.rawlog.npz"), "-p",
                            str(WORK / "tools.yaml"), "-v", "QUIET", "--device", args.device])
    sync()
    out["rawlog_filter"] = {"ms_per_frame": (time.perf_counter() - t0) * 1e3 / args.frames,
                            "launches": {n: getattr(nnb, n).launches for n in sweeps}}
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="an unpacked checkout to time beside this tree")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args)

    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from mp2p_icp_tpu_torch.eval.trajectory import load_kitti_poses

    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: this script times the card")
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    else:
        smi = "the CPU (a rehearsal: not a time of the card)"
    print(smi, flush=True)
    WORK.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _, _, scans = cs.write_apps_sequence(WORK / "sequence", args.frames, cs.APPS_RINGS,
                                         cs.APPS_AZIMUTHS)
    cs.write_rawlog(WORK / "in.rawlog.npz", scans)
    (WORK / "tools.yaml").write_text(cs.TOOLS_YAML)
    print(f"[apps] {args.frames} frames of {cs.APPS_RINGS} x {cs.APPS_AZIMUTHS} rays written "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)

    trees = {"this tree": ROOT}
    if args.baseline:
        trees["baseline"] = pathlib.Path(args.baseline).resolve()
    order = ["baseline", "this tree", "this tree", "baseline"] if args.baseline else ["this tree"]
    runs = {name: [] for name in trees}
    for turn, name in enumerate(order):
        env = dict(os.environ, PYTHONPATH=str(trees[name]))
        proc = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), "--worker",
                               "--frames", str(args.frames), "--tag", f"{turn}",
                               "--device", args.device],
                              cwd=trees[name], env=env, capture_output=True, text=True,
                              timeout=1200)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed:\n{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[name].append(got)
        print(f"[apps] turn {turn} {name}: " + ", ".join(
            f"{mode} {r['ms_per_frame']:.1f} ms a frame" for mode, r in got.items())
            + f" on {smi}", flush=True)

    summary = {"card": smi, "frames": args.frames, "runs": runs, "modes": {}}
    for mode in list(MODES) + ["rawlog_filter"]:
        line = {}
        for name in trees:
            ms = [r[mode]["ms_per_frame"] for r in runs[name]]
            line[name] = {"ms_per_frame": ms, "median": statistics.median(ms),
                          "launches": runs[name][0][mode]["launches"]}
            if "iterations" in runs[name][0][mode]:
                line[name]["iterations"] = runs[name][0][mode]["iterations"]
        if args.baseline and mode in MODES:
            a, b = (load_kitti_poses(runs[n][0][mode]["poses"]) for n in ("this tree", "baseline"))
            line["max_translation_difference_m"] = float(np.abs(a[:, :3, 3] - b[:, :3, 3]).max())
            line["max_rotation_difference"] = float(np.abs(a[:, :3, :3] - b[:, :3, :3]).max())
        summary["modes"][mode] = line
        print(f"[apps] {mode}: " + "; ".join(
            f"{n} {v['median']:.1f} ms a frame (turns {', '.join(f'{x:.1f}' for x in v['ms_per_frame'])}), "
            f"{v.get('iterations', '-')} iterations, launches {v['launches']}"
            for n, v in line.items() if isinstance(v, dict))
            + (f"; poses apart by at most {line['max_translation_difference_m']:.3g} m / "
               f"{line['max_rotation_difference']:.3g}" if "max_translation_difference_m" in line
               else "") + f" on {smi}", flush=True)
    (OUT / "apps_compare.json").write_text(json.dumps(summary, indent=1))
    for path in WORK.glob("**/*"):  # keep chiprun_out/ small: only the summary comes back
        if path.is_file():
            path.unlink()
    print(json.dumps({"ok": True, "card": smi}))


if __name__ == "__main__":
    main()
