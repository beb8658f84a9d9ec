"""One run of one cell, driven by data.

The cell is found by name in BENCHMARK.json; its configuration is
``configs/<config>.json``, its traffic ``traffic/<traffic>.json`` (whose
``kind`` names the driver ``drivers/<kind>.py``), the limits of its check
``limits/<cell>.json`` and each metric a reader ``metrics/<metric>.py``
(``read(readings)`` -> a number, or None where it finds nothing to read).
A new configuration, mix, cell or metric is a new file and an entry in
BENCHMARK.json: nothing here names one.

A run: the driver generates the inputs from the seed and builds the
program (set-up, with the kernels' build or load and a warm prefix of the
traffic that launches every shape it uses), then requests run back to back until the seconds
are up and the window closes when the last of them ends. With ``trace``
the window runs only as far as the traffic's traced requests and those the
check needs, the traced ones under ``trace.py``, and the per-layer metrics
are read from the trace; without, the end-to-end metrics. Then, with the
program's state freed, the driver's sample of answers is held against the
reference (``reference.py``) by the cell's limits.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mp2p_icp_tpu")


@dataclasses.dataclass
class Window:
    """The measured window: its host-clock start and end, and each request
    as (handed in, done, scans)."""

    start: float
    end: float
    requests: list


@dataclasses.dataclass
class Readings:
    """What the metric readers read."""

    setup_s: float
    window: Window
    log: Callable
    trace: Optional[dict] = None  # trace.summarize's numbers
    scans: Optional[int] = None  # scans and ICP iterations in the traced window
    iterations: Optional[int] = None

    @property
    def window_s(self) -> float:
        return self.window.end - self.window.start


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module of the file ``path``, loaded once per process as ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def spec_of(root: Path = HERE) -> dict:
    """BENCHMARK.json of the checkout whose benchmark directory is ``root``."""
    return load_json(root.parent / "BENCHMARK.json")


def cell_of(spec: dict, name: str, root: Path = HERE):
    """(workload entry, configuration, traffic, limits) of cell ``name``;
    ``root`` is the benchmark directory (files named in BENCHMARK.json are
    relative to its parent)."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; cells: {', '.join(sorted(cells))}")
    w = cells[name]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    limits = root / "limits" / f"{name}.json"
    return (w, load_json(root.parent / cfg["file"]),
            load_json(root / "traffic" / f"{w['traffic']}.json"),
            load_json(limits) if limits.exists() else {})


def metrics_of(spec: dict, cell: str, trace: bool) -> list:
    """The cell's metric entries: end-to-end without a trace, per-layer
    with one; an entry with ``workloads`` applies to those cells only."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def driver_of(kind: str, root: Path = HERE):
    return load_module(root / "drivers" / f"{kind}.py", f"benchmark.drivers.{kind}").Driver


def read_metric(entry: dict, readings: Readings, root: Path = HERE):
    name = "benchmark_metric_" + entry["name"].replace(".", "_")
    return load_module(root / "metrics" / f"{entry['name']}.py", name).read(readings)


def breakdown_of(summary: dict) -> dict:
    """The traced run's breakdown: the device operations that took most
    time and the idle time by what the host was doing, 10 each."""
    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(summary["device_ops"]), "idle_gaps": top(summary["idle_by_stage"])}


def run(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
        t_start: Optional[float] = None, root: Path = HERE):
    """One run; returns the result line (a dict, ``checks`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec_of(root)
    w, cfg, traffic, limits = cell_of(spec, cell, root)
    device = torch.device(device)
    if device.type == "cuda":
        from benchmark import programs

        t0 = time.perf_counter()
        programs.build_kernels()
        log(f"[setup] kernels built or found in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    drv = driver_of(traffic["kind"], root)(cfg, traffic, seed, device, log)
    t1 = time.perf_counter()
    drv.warm()
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {setup_s:.3f} s: inputs and program {t1 - t0:.3f} s, warm pass "
        f"{time.perf_counter() - t1:.3f} s, before them {t0 - t_start:.3f} s")

    tracer = None
    if trace:
        from benchmark.trace import Tracer

        tracer = Tracer(log)
    window = drv.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    readings = Readings(setup_s=setup_s, window=window, log=log)
    if tracer is not None and tracer.prof is not None:
        readings.trace = tracer.reduce()
        readings.scans, readings.iterations = tracer.scans, tracer.iterations
    metrics = {}
    for entry in metrics_of(spec, cell, trace):
        value = read_metric(entry, readings, root)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}

    drv.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    from benchmark import checks, reference

    numbers = drv.compare(drv.program(), drv.reference(reference.FLOAT64))
    correct, rows = checks.judge(numbers, limits)
    log(f"[check] reference and comparison in {time.perf_counter() - t0:.1f} s; numbers "
        f"without a limit: {json.dumps({k: v for k, v in numbers.items() if k not in limits})}")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": w["chips"], "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": len(window.requests), "failed": 0,
            "metrics": metrics, "device": dev}
    if readings.trace is not None:
        s = readings.trace
        dev.update(busy_s=s["busy_s"], window_s=s["window_s"])
        line["breakdown"] = breakdown_of(s)
        line["stages"] = s["stages"]
        line["iterations_per_scan"] = (readings.iterations / readings.scans
                                       if readings.scans else None)
    line["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    return line


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def check_lines(line: dict) -> list:
    return [f"[check] {name} = {c['value']!r} (limit {c['limit']!r})"
            for name, c in line["checks"].items()] + [f"[check] correct = {line['correct']}"]
