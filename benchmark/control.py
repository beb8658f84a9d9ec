#!/usr/bin/env python3
"""The readings that a cell's limits are set from (not run by the benchmark's runs).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3]
                                 [--seconds s] [--out file.jsonl]

For each of --seeds: the cell's inputs from the seed, the program's timed
path for a short window at the cell's own load (a run's set-up and window,
untimed), and the numbers of its answers against the float64 reference:
the lower readings. For each of --control-seeds: the control, the
reference computed in TF32 in the program's place, against the float64
reference: the upper readings. One JSON line per seed on stdout (and in
--out). One process for all seeds; the card's kernels are built once.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, reference

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 2
        from benchmark import programs

        programs.build_kernels()
    spec = harness.spec_of()
    _, cfg, traffic, limits = harness.cell_of(spec, args.workload)
    Driver = harness.driver_of(traffic["kind"])
    out = open(args.out, "a") if args.out else None

    def emit(row):
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()

    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            drv = Driver(cfg, traffic, seed, device, harness.log)
            if kind == "program":
                drv.warm()
                drv.window(args.seconds)
                drv.release()
                numbers = drv.compare(drv.program(), drv.reference(reference.FLOAT64))
            else:
                tf32 = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    ctl = drv.reference(reference.TF32)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                numbers = drv.compare(ctl, drv.reference(reference.FLOAT64))
            emit({"cell": args.workload, "kind": kind, "seed": seed, "numbers": numbers,
                  "limits": limits, "seconds": time.perf_counter() - t0,
                  "device": torch.cuda.get_device_name(device) if device.type == "cuda"
                  else "cpu"})
            del drv
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
