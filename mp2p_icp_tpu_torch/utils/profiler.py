"""Profiling / tracing utilities: the program's one span and counter
facility.

Port of ``mp2p_icp_tpu/utils/profiler.py`` (reference parity: mrpt
CTimeLogger spans named align, align.1_prepare, align.3.1_matchers ...,
ICP.cpp:46-342, enabled by ``icp-run --profiler``; stats dumped at
destruction).

- ``profile_scope(name)``: the program's span. While a ``torch.profiler``
  trace runs it is a ``record_function`` range, so the trace carries the
  span's name beside the kernels it launched (the JAX package's
  ``TraceAnnotation`` + ``named_scope``); while a ``Profiler`` is installed
  (``Profiler.installed``) its host time goes to that profiler. With
  neither, it returns one shared no-op context after one check (well
  under a microsecond; a ``record_function`` costs ~15 us even with no
  trace running). A span launches nothing and reads nothing back from the
  card.
- ``Profiler``: host-side wall-clock span accumulator with the same
  nested-name convention and the same stats report (per-call
  mean/min/max). The host clock, no device sync, as in the JAX package and
  the reference's CTimeLogger: a span that launches work on the card
  measures the launch, not the work. ``Profiler.scope`` is the same span
  as ``profile_scope``, timed into that profiler.
- ``count(name, *values)``: the program's counter. While a trace runs it
  keeps the values (device tensors stay on the device, by reference) in
  a list that ``drain_counts`` hands over and empties after the traced
  window; otherwise it does nothing.

Span names are ``<layer>.<part>``: ``odometry.step`` and ``icp.align`` are
the roots of one request (a frame, an align), and every span a request
opens on its thread nests inside its root. A ``sync.<site>`` span holds
a call that waits for the card, a host read of device values or a copy
from the host, and nothing else.
"""

from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

# whether a torch.profiler (or autograd profiler) trace runs; ~0.1 us
_tracing = torch._C._autograd._profiler_enabled

_installed: Optional["Profiler"] = None  # the Profiler that profile_scope times into
_counts: list = []  # count()'s records of the running trace, until drained


class _Off:
    """The shared span that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, kind, value, traceback):
        return None


_OFF = _Off()


class _Span:
    """A live span: a record_function range while a trace runs, and the
    host time into ``prof`` (None: no Profiler)."""

    __slots__ = ("name", "prof", "range", "t0")

    def __init__(self, name: str, prof: Optional["Profiler"]):
        self.name, self.prof, self.range = name, prof, None

    def __enter__(self):
        if self.prof is not None:
            self.t0 = time.perf_counter()
        if _tracing():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        return None

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.prof is not None:
            self.prof._spans[self.name].append(time.perf_counter() - self.t0)
        return None


class Profiler:
    """Host-side span accumulator (CTimeLogger analogue)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._spans: Dict[str, List[float]] = defaultdict(list)

    def scope(self, name: str):
        """A span timed into this profiler (and named in a running trace)."""
        return _Span(name, self) if self.enabled else _OFF

    @contextlib.contextmanager
    def installed(self):
        """``with prof.installed():`` times every ``profile_scope`` span
        the program opens inside the block into this profiler (the
        previous one, if any, is put back after it)."""
        global _installed
        prev, _installed = _installed, (self if self.enabled else None)
        try:
            yield self
        finally:
            _installed = prev

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


def profile_scope(name: str):
    """The span ``name`` (a context manager): a record_function range in a
    running torch.profiler trace, host time into the installed Profiler,
    and the shared no-op when there is neither."""
    prof = _installed
    if prof is None and not _tracing():
        return _OFF
    return _Span(name, prof)


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(f):
        @functools.wraps(f)
        def call(*args, **kwargs):
            with profile_scope(name):
                return f(*args, **kwargs)
        return call
    return wrap


def count(name: str, *values) -> None:
    """Record ``values`` (ints, or tensors kept on their device unread)
    under ``name`` while a trace runs; a no-op otherwise."""
    if _tracing():
        _counts.append((name, values))


def drain_counts() -> list:
    """The [(name, values)] that ``count`` recorded since the last drain,
    in order; the list is emptied."""
    out = _counts[:]
    _counts.clear()
    return out
