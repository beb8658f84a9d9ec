"""The program's own spans and counters in a traced window.

The program (``mp2p_icp_tpu_torch/utils/profiler.py``) opens
``record_function`` spans named ``<layer>.<part>`` at its layer
boundaries (``odometry.step`` and ``icp.align`` are the roots of a
request; ``icp.iter`` holds ``icp.match``, ``icp.solve``,
``icp.terminate``; a ``sync.<site>`` span holds a call that waits for the
card) and, while a trace runs, keeps a ``knn.rows`` record of every kNN
sweep: (k, problems, query rows, point rows, shared map), the rows as the
counts the sweep was handed on the device. ``reduce`` turns the same chrome-trace events that
``trace.summarize`` reads, plus those records, into the ``program``
section. The benchmark's own ``bench.*`` spans are not program spans and
change nothing here.

For each program span name:

- ``calls``, ``seconds`` (host time), ``self_s`` (its time less what its
  child program spans cover);
- ``launches``, ``syncs``, ``dtoh``, ``htod``: kernel launches, stream or
  device synchronisations and copies to / from the host issued with it as
  the innermost program span open (a copy by its runtime call);
- ``launches_incl``: launches issued anywhere inside it;
- ``idle_s``: the device's idle time whose gap starts while it is the
  innermost program span open, on the trace's shared clock (the rule that
  ``trace.summarize`` applies to the ``bench.*`` spans);
- ``under``: {enclosing span name: seconds of this span inside it}.

``other`` holds the events that no program span encloses. ``knn`` pairs the
i-th ``knn.rows`` record with the i-th ``knn.query`` span: [(bound of the
rows, device time of the kernels launched inside the span)], None where
the two counts differ or there is no call.
"""

from __future__ import annotations

import bisect
import importlib

import torch

from benchmark import roofline
from benchmark.trace import DEVICE_CATS, LAUNCH, SYNC

PROFILER = "mp2p_icp_tpu_torch.utils.profiler"
OTHER = "other"
KEYS = ("launches", "syncs", "dtoh", "htod", "launches_incl")


def drain() -> list:
    """The program's counter records since the last drain ([] where the
    program has no counter)."""
    try:
        mod = importlib.import_module(PROFILER)
    except ImportError:
        return []
    return mod.drain_counts() if hasattr(mod, "drain_counts") else []


class _Stack:
    """The program spans open at each of a non-decreasing series of host
    times (outer first); a span [start, end) is open from its start to
    before its end. Spans nest (one host thread) and come sorted by start,
    the outer first."""

    def __init__(self, spans):
        self.spans = spans
        self.i = 0
        self.open = []

    def __call__(self, ts: float) -> list:
        while self.i < len(self.spans) and self.spans[self.i][0] <= ts:
            s, e, name = self.spans[self.i]
            while self.open and self.open[-1][0] <= s:
                self.open.pop()
            self.open.append((e, name))
            self.i += 1
        while self.open and self.open[-1][0] <= ts:
            self.open.pop()
        return [name for _, name in self.open]


def _rows(values):
    """A ``knn.rows`` record as roofline.knn_bound_s's arguments."""
    k, B, q, p, shared = values
    q = torch.as_tensor(q).reshape(-1).tolist()
    p = torch.as_tensor(p).reshape(-1).tolist()
    if len(q) == 1:
        q = q * B
    if len(p) == 1 and not shared:
        p = p * B
    return int(k), q, p, bool(shared)


def reduce(events: list, records: list) -> dict:
    """Chrome-trace events (ts and dur in us) of one traced window, with a
    ``bench.window`` span, and the program's counter records of it ->
    {"spans": {name: {...}}, "knn": [(bound_s, device_s)] or None}."""
    xs = [e for e in events if e.get("ph") == "X"]
    win = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == "bench.window"]
    if not win:
        raise ValueError("the trace holds no bench.window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])

    def inside(e):
        return w0 <= float(e["ts"]) <= w1

    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                    if e.get("cat") == "user_annotation" and not e["name"].startswith("bench.")
                    and inside(e)), key=lambda s: (s[0], -s[1]))
    runtime = sorted((e for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and inside(e)), key=lambda e: float(e["ts"]))
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS and inside(e)]
    host_of = {}  # correlation -> the runtime call's host time
    for e in runtime:
        c = (e.get("args") or {}).get("correlation")
        if c is not None:
            host_of[c] = float(e["ts"])

    def entry():
        return {"calls": 0, "seconds": 0.0, "self_s": 0.0, **{k: 0 for k in KEYS},
                "idle_s": 0.0, "under": {}}

    out = {OTHER: entry()}
    opened = []  # (end, name) of the spans open at each start
    for s, e, name in spans:
        st = out.setdefault(name, entry())
        while opened and opened[-1][0] <= s:
            opened.pop()
        st["calls"] += 1
        st["seconds"] += (e - s) * 1e-6
        st["self_s"] += (e - s) * 1e-6
        if opened:
            out[opened[-1][1]]["self_s"] -= (e - s) * 1e-6
        for anc in {n for _, n in opened} - {name}:
            st["under"][anc] = st["under"].get(anc, 0.0) + (e - s) * 1e-6
        opened.append((e, name))

    # events by the host time of their issue: launches and syncs, copies
    # by their runtime call
    issued = [(float(e["ts"]), "launches" if e["name"] in LAUNCH else "syncs")
              for e in runtime if e["name"] in LAUNCH or e["name"] in SYNC]
    for e in dev:
        if e.get("cat") != "gpu_memcpy":
            continue
        kind = "dtoh" if "DtoH" in e["name"] else "htod" if "HtoD" in e["name"] else None
        if kind is not None:
            issued.append((host_of.get((e.get("args") or {}).get("correlation"),
                                       float(e["ts"])), kind))
    issued.sort()
    stack = _Stack(spans)
    for ts, kind in issued:
        names = stack(ts)
        out[names[-1] if names else OTHER][kind] += 1
        if kind == "launches":
            for name in set(names):
                out[name]["launches_incl"] += 1

    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    stack = _Stack(spans)
    prev = w0
    for s, e in iv + [(w1, w1)]:
        if s > prev:
            names = stack(prev)
            out[names[-1] if names else OTHER]["idle_s"] += (s - prev) * 1e-6
        prev = max(prev, e)

    knn_spans = [(s, e) for s, e, name in spans if name == "knn.query"]
    rows = [values for name, values in records if name == "knn.rows"]
    knn = None
    if rows and len(rows) == len(knn_spans):
        kern = sorted((host_of[c], float(e["dur"])) for e in dev if e.get("cat") == "kernel"
                      for c in [(e.get("args") or {}).get("correlation")] if c in host_of)
        starts = [ts for ts, _ in kern]
        knn = []
        for values, (s, e) in zip(rows, knn_spans):
            lo, hi = bisect.bisect_left(starts, s), bisect.bisect_right(starts, e)
            knn.append((roofline.knn_bound_s(*_rows(values)),
                        sum(d for _, d in kern[lo:hi]) * 1e-6))
    return {"spans": out, "knn": knn}


def iterations(r):
    """The ``icp.iter`` entry of a reading's program section, or None
    where there is none or it counts no call."""
    if r.trace is None or not r.trace.get("program"):
        return None
    it = r.trace["program"]["spans"].get("icp.iter")
    return it if it and it["calls"] else None


def per_iteration(r, name: str, key: str):
    """``key`` of program span ``name`` per ``icp.iter`` call (0 where the
    span never opened), or None without ICP iterations."""
    it = iterations(r)
    if it is None:
        return None
    return r.trace["program"]["spans"].get(name, {}).get(key, 0) / it["calls"]
