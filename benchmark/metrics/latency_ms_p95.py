"""The 95th percentile of every request's latency in the window (host
clock, ms): from when the benchmark hands the input in to when its pose is
on the host after a synchronisation."""

from benchmark.stats import percentile


def read(r):
    ms = [(end - start) * 1e3 for start, end, _ in r.window.requests]
    p95 = percentile(ms, 95)
    r.log(f"[latency] {len(ms)} requests, median {percentile(ms, 50):.3f} ms, p95 {p95:.3f} ms, "
          f"{sum(x > p95 for x in ms)} beyond it, max {max(ms):.3f} ms")
    return p95
