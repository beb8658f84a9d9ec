"""The traced run: torch.profiler over a window of the cell's requests, the
benchmark's own spans around the calls into each layer of the program, the
kNN front ends' valid rows, and the reduction of the trace to the numbers
that the per-layer metrics read.

Spans (record_function ranges, opened by wrappers installed for the traced
window only and removed after it) are named ``bench.<stage>``. The kNN
front ends (``knn_bruteforce`` / ``knn_bruteforce_batched`` wherever a
module of the program holds them) also record the valid rows of each call
(mask sums on the device; under torch.func.vmap the counts the sweep gets),
read after the window; the sweeps are wrapped to see those counts.

Copied arithmetic: chip_smoke.profile_window's counts (kernel time over
wall, cudaLaunchKernel / synchronize / copy calls). The device's busy time
here is the union of its kernels, copies and sets in the window.
"""

from __future__ import annotations

import bisect
import importlib
import inspect
import json
import os
import sys
import tempfile
import time

import torch

from benchmark import roofline
from benchmark.stats import union_length

# (module, attribute, span): the stages whose calls get a span
STAGES = (
    ("mp2p_icp_tpu_torch.filters.deskew", "FilterDeskew.__call__", "deskew"),
    ("mp2p_icp_tpu_torch.filters.decimate_voxels", "FilterDecimateVoxels.__call__", "decimate"),
    ("mp2p_icp_tpu_torch.icp", "ICP._crop_globals", "crop"),
    ("mp2p_icp_tpu_torch.odometry", "crop_batched", "crop"),
    ("mp2p_icp_tpu_torch.icp", "ICP._align_core", "align"),
    ("mp2p_icp_tpu_torch.odometry", "_align_batched", "align"),
    ("mp2p_icp_tpu_torch.odometry", "hash_map_insert", "map_insert"),
    ("mp2p_icp_tpu_torch.odometry", "OdometryMapper._fit", "normals_fit"),
)
NN = "mp2p_icp_tpu_torch.ops.nn_bruteforce"
FRONT_ENDS = ("knn_bruteforce", "knn_bruteforce_batched")
SWEEPS = ("knn_sweep", "knn_sweep_streamed", "knn_sweep_batched")
LAUNCH = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _resolve(module: str, attr: str):
    """(owner, name, value) of module.attr (attr may be Class.method), or
    None where the name no longer exists."""
    try:
        owner = importlib.import_module(module)
        *path, name = attr.split(".")
        for p in path:
            owner = getattr(owner, p)
        return owner, name, owner.__dict__[name] if isinstance(owner, type) else getattr(owner, name)
    except (ImportError, AttributeError, KeyError):
        return None


def _spanned(f, span):
    def g(*a, **kw):
        with torch.profiler.record_function(f"bench.{span}"):
            return f(*a, **kw)
    return g


class Patches:
    """Attribute replacements undone in reverse order."""

    def __init__(self):
        self.saved = []

    def set(self, owner, name, value):
        self.saved.append((owner, name, owner.__dict__[name] if isinstance(owner, type)
                           else getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        for owner, name, value in reversed(self.saved):
            setattr(owner, name, value)
        self.saved = []


class KnnRecorder:
    """Each front-end call's k and valid rows, on the device until read."""

    def __init__(self):
        self.calls = []
        self.missing = []

    def install(self, patches: Patches):
        nn = importlib.import_module(NN)
        for name in FRONT_ENDS:
            orig = getattr(nn, name, None)
            if orig is None:
                self.missing.append(f"{NN}.{name}")
                continue
            wrapper = self._front_end(orig)
            # every module of the program that holds the function by name
            for mod in list(sys.modules.values()):
                if (getattr(mod, "__name__", "").split(".")[0] == "mp2p_icp_tpu_torch"
                        and getattr(mod, name, None) is orig):
                    patches.set(mod, name, wrapper)
        for name in SWEEPS:
            orig = getattr(nn, name, None)
            if orig is None:
                self.missing.append(f"{NN}.{name}")
                continue
            patches.set(nn, name, self._sweep(orig))

    def _front_end(self, orig):
        sig = inspect.signature(orig)
        batched = torch._C._functorch.is_batchedtensor

        def call(*a, **kw):
            args = sig.bind(*a, **kw)
            args.apply_defaults()
            qv, pv = args.arguments["query_valid"], args.arguments["point_valid"]
            rec = {"k": int(args.arguments["k"]), "vmap": batched(qv) or batched(pv),
                   "shared": pv.ndim == 1 and qv.ndim == 2}
            self.calls.append(rec)
            with torch.profiler.record_function("bench.knn"):
                out = orig(*a, **kw)
            if not rec["vmap"]:  # counted after the span: no launch inside it
                rec["q"], rec["p"] = qv.sum(-1), pv.sum(-1)
            return out
        return call

    def _sweep(self, orig):
        sig = inspect.signature(orig)

        def call(*a, **kw):
            rec = self.calls[-1] if self.calls else None
            if rec is not None and rec["vmap"] and "q" not in rec:
                args = sig.bind(*a, **kw).arguments
                q, p = args["q"], args["p"]
                rec["q"], rec["p"] = args.get("q_count"), args.get("p_count")
                rec["shared"] = p.ndim == 2 and q.ndim == 3
            return orig(*a, **kw)
        call.launches = getattr(orig, "launches", 0)
        return call

    def rows(self):
        """[(k, [queries per problem], [points per problem], shared)], or
        None where a call's counts are missing."""
        out = []
        for c in self.calls:
            if c.get("q") is None:
                return None
            out.append((c["k"], c["q"].reshape(-1).tolist(), c["p"].reshape(-1).tolist(),
                        c["shared"]))
        return out


class Tracer:
    """The traced window: ``begin`` and ``end`` are called by the driver at
    request boundaries; ``note`` gives the scans and ICP iterations inside."""

    def __init__(self, log):
        self.log = log
        self.prof = None
        self.scans = self.iterations = None
        self.patches = Patches()
        self.knn = KnnRecorder()
        self.missing = []
        self._span = None

    def begin(self):
        for module, attr, span in STAGES:
            found = _resolve(module, attr)
            if found is None:
                self.missing.append(f"{module}.{attr}")
                continue
            owner, name, f = found
            self.patches.set(owner, name, _spanned(f, span))
        self.knn.install(self.patches)
        for name in self.missing + self.knn.missing:
            self.log(f"[trace] {name} no longer exists: its span or count is missing")
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._span = torch.profiler.record_function("bench.window")
        self._span.__enter__()
        self.t0 = time.perf_counter()

    def end(self):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self._span.__exit__(None, None, None)
        self.prof.stop()
        self.patches.undo()

    @staticmethod
    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def note(self, scans: int, iterations: int):
        self.scans, self.iterations = scans, iterations

    def reduce(self):
        """The trace as numbers (``summarize``), read once after the run."""
        t0 = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        summary = summarize(events, self.knn.rows())
        self.log(f"[trace] {len(events)} trace events reduced in "
                 f"{time.perf_counter() - t0:.1f} s; host window {self.window_s:.4f} s")
        return summary


class _Labeller:
    """The innermost span (by name, without "bench.") open at each of a
    non-decreasing series of host times, a span [start, end) open from its
    start to before its end; spans nest (one host thread) and come sorted by
    start, the outer first."""

    def __init__(self, spans):
        self.spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                       e["name"][len("bench."):]) for e in spans]
        self.i = 0
        self.stack = []

    def __call__(self, ts: float) -> str:
        while self.i < len(self.spans) and self.spans[self.i][0] <= ts:
            s, e, name = self.spans[self.i]
            while self.stack and self.stack[-1][0] <= s:
                self.stack.pop()
            self.stack.append((e, name))
            self.i += 1
        while self.stack and self.stack[-1][0] <= ts:
            self.stack.pop()
        return self.stack[-1][1] if self.stack else "other"


def summarize(events: list, knn_rows) -> dict:
    """Chrome-trace events (ts and dur in us) of one traced window -> dict:
    window_s, busy_s, launches, syncs, dtoh, device_ops {name: s},
    stages {span: {"launches", "syncs", "seconds"}}, idle_by_stage {span: s},
    knn [(bound_s, device_s)] (None where the counts or spans are
    missing)."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == "bench.window"]
    if not win:
        raise ValueError("the trace holds no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])

    def inside(e):
        return w0 <= float(e["ts"]) <= w1

    dev = [e for e in xs if e.get("cat") in DEVICE_CATS and inside(e)]
    runtime = [e for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver") and inside(e)]
    spans = [e for e in xs if e.get("cat") == "user_annotation" and e["name"].startswith("bench.")
             and e["name"] != "bench.window" and inside(e)]
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    busy_us = union_length(iv)
    out = {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6}
    out["launches"] = sum(1 for e in runtime if e["name"] in LAUNCH)
    out["syncs"] = sum(1 for e in runtime if e["name"] in SYNC)
    out["dtoh"] = sum(1 for e in dev if e.get("cat") == "gpu_memcpy" and "DtoH" in e["name"])
    ops = {}
    for e in dev:
        ops[e["name"]] = ops.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    out["device_ops"] = ops

    spans.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
    launches = sorted(runtime, key=lambda e: float(e["ts"]))
    label = _Labeller(spans)
    stages = {}
    for e in launches:
        st = stages.setdefault(label(float(e["ts"])), {"launches": 0, "syncs": 0, "seconds": 0.0})
        st["launches"] += e["name"] in LAUNCH
        st["syncs"] += e["name"] in SYNC
    for e in spans:
        name = e["name"][len("bench."):]
        stages.setdefault(name, {"launches": 0, "syncs": 0, "seconds": 0.0})["seconds"] += (
            float(e["dur"]) * 1e-6)
    out["stages"] = stages

    idle = {}
    label = _Labeller(spans)
    prev = w0
    for s, e in iv + [(w1, w1)]:
        if s > prev:
            name = label(prev)
            idle[name] = idle.get(name, 0.0) + (s - prev) * 1e-6
        prev = max(prev, e)
    out["idle_by_stage"] = idle

    knn_spans = [e for e in spans if e["name"] == "bench.knn"]
    out["knn"] = None
    if knn_rows is not None and len(knn_rows) == len(knn_spans) and knn_rows:
        corr = {}
        for e in runtime:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                corr[c] = float(e["ts"])
        kern = [(corr.get((e.get("args") or {}).get("correlation")), float(e["dur"]))
                for e in dev if e.get("cat") == "kernel"]
        kern = sorted((ts, d) for ts, d in kern if ts is not None)
        starts = [k[0] for k in kern]
        calls = []
        for (k, q, p, shared), e in zip(knn_rows, knn_spans):
            s, t = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, t)
            dev_s = sum(d for _, d in kern[lo:hi]) * 1e-6
            calls.append((roofline.knn_bound_s(k, q, p, shared), dev_s))
        out["knn"] = calls
    return out
