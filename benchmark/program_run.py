#!/usr/bin/env python3
"""A traced run of one cell that also reads the program's own spans and
counter.

    python3 benchmark/program_run.py --workload <cell> --seed <n> --seconds <s>

It is ``run.py --workload <cell> ... --trace 1``, the same window and the
same result line, with two keys more: ``program_stages``, the program
section of ``program_trace.py`` (each program span's calls, seconds, self
seconds, launches, syncs, copies and idle time), and ``program_metrics``,
the per-layer readers of ``benchmark/metrics/`` that read that section
(``PROGRAM_METRICS``). ``run.py`` itself does not read the program's spans
yet: ``trace.Tracer.reduce`` would store ``program_trace.reduce`` under
``"program"`` and ``harness.run`` put its spans in the line.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import harness, program_trace, trace  # noqa: E402
from benchmark import run as bench_run  # noqa: E402  (sets run.py's environment)

PROGRAM_METRICS = ("icp.match_launches_per_iter", "icp.solve_launches_per_iter",
                   "icp.host_wait_pct", "knn.program_roofline")


def with_program(run_fn):
    """``harness.run`` (or a function of its signature) whose traced
    window's numbers also hold the program section, and whose result line
    carries ``program_stages`` and ``program_metrics``."""
    def run(*args, root: Path = harness.HERE, **kwargs):
        kept = {}
        base = trace.summarize

        def summarize(events, knn_rows):
            out = base(events, knn_rows)
            out["program"] = program_trace.reduce(events, program_trace.drain())
            kept["summary"] = out
            return out

        trace.summarize = summarize
        try:
            line = run_fn(*args, root=root, **kwargs)
        finally:
            trace.summarize = base
        if "summary" in kept:
            s = kept["summary"]
            readings = harness.Readings(setup_s=0.0, window=None, log=harness.log, trace=s)
            line["program_stages"] = s["program"]["spans"]
            line["program_metrics"] = {
                name: harness.read_metric({"name": name}, readings, root)
                for name in PROGRAM_METRICS}
        return line
    return run


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" in argv:
        print("program_run.py always traces: drop --trace", file=sys.stderr)
        return 2
    bench_run.T_START = T_START
    harness.run = with_program(harness.run)
    return bench_run.main(argv + ["--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
