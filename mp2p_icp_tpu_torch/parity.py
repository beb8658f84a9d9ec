"""Tie-tolerant comparison of two kNN results (numpy only).

Exact index equality is too strict a test of a kNN: two neighbours at the
same distance may come back in either order, and the JAX package's
distances are approximate at street scale (its |p|² - 2q·p + |q|² form
cancels in f32, ~1e-3 m² at 60 m). So a result is held to a reference
rank by rank, through the TRUE squared distance of the neighbour it chose.
Used by the parity tests and by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

TIE_TOL = 2e-3  # m², the reference's approximation band


def true_dist_sq(queries, points, idx):
    """f64 squared distance of each query to its chosen points; NaN where
    idx < 0. queries [Q, 3], points [C, 3], idx [Q, k]."""
    q = np.asarray(queries, np.float64)
    p = np.asarray(points, np.float64)
    idx = np.asarray(idx)
    nb = p[np.clip(idx, 0, len(p) - 1)]  # [Q, k, 3]
    d = np.sum((q[:, None, :] - nb) ** 2, axis=-1)
    return np.where(idx >= 0, d, np.nan)


def knn_mismatch(queries, points, idx, valid, ref_idx, ref_dist_sq, ref_valid,
                 radius_sq=None, tol=TIE_TOL):
    """[Q, k] mask of the entries where a kNN result (idx, valid) disagrees
    with a reference (ref_idx, ref_dist_sq, ref_valid) by more than a tie:

    - both valid, but the true d² of the chosen neighbour is more than
      ``tol`` away from the true d² of the reference's neighbour at the same
      rank (true: f64 from the coordinates, so the reference's own rounding
      of its reported distance does not count against the result);
    - one valid and the other not, unless the pair sits within ``tol`` of
      the radius gate (``radius_sq``: scalar or [Q]) by the true d² or by
      the reference's reported d².
    """
    valid = np.asarray(valid, bool)
    ref_valid = np.asarray(ref_valid, bool)
    d = true_dist_sq(queries, points, np.where(valid, idx, -1))
    d_ref = true_dist_sq(queries, points, np.where(ref_valid, ref_idx, -1))
    both = valid & ref_valid
    far = np.zeros(valid.shape, bool)
    far[both] = np.abs(d[both] - d_ref[both]) > tol
    differ = valid != ref_valid
    if radius_sq is not None:
        r = np.asarray(radius_sq, np.float64)
        r = np.broadcast_to(r[:, None] if r.ndim == 1 else r, valid.shape)
        near_r = np.zeros(valid.shape, bool)
        for cand, ok in ((d, valid), (d_ref, ref_valid),
                         (np.asarray(ref_dist_sq, np.float64), ref_valid)):
            near_r |= ok & (np.abs(cand - r) <= tol)
        differ = differ & ~near_r
    return far | differ
