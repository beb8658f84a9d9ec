"""Profiling / tracing utilities.

Port of ``mp2p_icp_tpu/utils/profiler.py`` (reference parity: mrpt
CTimeLogger spans named align, align.1_prepare, align.3.1_matchers ...,
ICP.cpp:46-342, enabled by ``icp-run --profiler``; stats dumped at
destruction).

- ``Profiler``: host-side wall-clock span accumulator with the same
  nested-name convention and the same stats report (per-call
  mean/min/max). The host clock, no device sync, as in the JAX package and
  the reference's CTimeLogger: a span that launches work on the card
  measures the launch, not the work.
- ``profile_scope``: wraps a span in ``torch.profiler.record_function``, so
  a ``torch.profiler`` trace carries the span's name beside the kernels it
  launched (the JAX package's ``TraceAnnotation`` + ``named_scope``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch


class Profiler:
    """Host-side span accumulator (CTimeLogger analogue)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._spans: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def scope(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            with profile_scope(name):
                yield
        finally:
            self._spans[name].append(time.perf_counter() - t0)

    def stats(self) -> Dict[str, dict]:
        out = {}
        for name, ts in sorted(self._spans.items()):
            out[name] = {
                "calls": len(ts),
                "mean_ms": 1e3 * sum(ts) / len(ts),
                "min_ms": 1e3 * min(ts),
                "max_ms": 1e3 * max(ts),
                "total_s": sum(ts),
            }
        return out

    def report(self) -> str:
        lines = [
            f"{'span':40s} {'calls':>6s} {'mean[ms]':>10s} {'min[ms]':>10s} "
            f"{'max[ms]':>10s} {'total[s]':>9s}"
        ]
        for name, s in self.stats().items():
            lines.append(
                f"{name:40s} {s['calls']:6d} {s['mean_ms']:10.2f} "
                f"{s['min_ms']:10.2f} {s['max_ms']:10.2f} {s['total_s']:9.3f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def profile_scope(name: str):
    """A named range in torch.profiler traces (host and device timelines)."""
    with torch.profiler.record_function(name):
        yield
