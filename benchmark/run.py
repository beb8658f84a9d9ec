#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the
cell asks for (BENCHMARK.json). Set-up (the kernels' build or load, the
inputs from the seed, a warm prefix of the traffic) is timed from the
start of this process; then requests run for --seconds, and the window
closes when the last of them ends. --trace 1 runs only the traffic's
traced requests (and those the check needs) and reports the per-layer
metrics instead of the end-to-end ones. Every run then holds a sample of
the program's answers against the plain reference.

stdout's last line is the result: {"correct", "attempted", "failed",
"metrics", "device"[, "breakdown", ...], "checks"}; stderr's last lines are
each number checked beside its limit. Exits 2 without enough CUDA devices
and 3 if jax, jaxlib, flax or mp2p_icp_tpu was loaded, printing no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# one process with few threads: the program's work on the host is its
# Python thread issuing launches; idle intra-op CPU workers only compete
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
# every kernel cache at a fixed path inside the checkout (the program builds
# its own kernels into build/ at the checkout's root)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.spec_of()
    chips = next((w["chips"] for w in spec["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no run",
              file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                           T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules that the benchmark may not load were loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for row in harness.check_lines(line):
        print(row, file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
