"""The card's published peaks and the least time a kNN call can take.

Copied from chip_smoke.py (``FP32_INSTRUCTIONS_PER_S``, ``BYTES_PER_S``,
``work_bound_ms``): the sweeps issue 9 FP32 instructions per query-point
pair (3 sub, 3 mul, 2 add, 1 compare; no FMA, so that they are bit-equal to
the plain kNN), and NVIDIA's data sheet for the H100 SXM gives 67 TFLOP/s
of FP32 outside the tensor cores, 33.5 T instructions/s, and 3.35 TB/s of
HBM. The bound is that of the work the call's inputs need, whatever k is:
its valid query rows against its valid point rows, each row read once and
k results written per query.
"""

from __future__ import annotations

FP32_INSTRUCTIONS_PER_S = 67.0e12 / 2
BYTES_PER_S = 3.35e12
INSTRUCTIONS_PER_PAIR = 9


def work_bound_s(pairs: float, queries: float, points: float, k: int) -> float:
    """max(instructions / peak, bytes / bandwidth) in seconds: ``pairs``
    query-point pairs compared, ``queries`` + ``points`` rows of 12 bytes
    read, k (distance, index) pairs of 8 bytes written per query."""
    ops = pairs * INSTRUCTIONS_PER_PAIR / FP32_INSTRUCTIONS_PER_S
    moved = (12.0 * (queries + points) + 8.0 * queries * k) / BYTES_PER_S
    return max(ops, moved)


def knn_bound_s(k: int, queries: list, points: list, shared: bool) -> float:
    """The bound of one front-end call of len(queries) problems: problem b
    compares queries[b] valid queries with points[b] valid points (a shared
    map gives one count, read once)."""
    if shared or len(points) == 1:
        p = [points[0]] * len(queries)
        read = points[0]
    else:
        p, read = points, sum(points)
    pairs = sum(q * c for q, c in zip(queries, p))
    return work_bound_s(pairs, sum(queries), read, k)
