"""The numbers that decide ``correct``: the program's answers against the
reference's, and the reference's own answers in the control's precision
against its float64 answers (the control)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import reference, se3

MATCH_M = 0.05  # two map points this close are one point: a tenth of a voxel


def pose_gaps(a: np.ndarray, b: np.ndarray):
    """(max translation gap in m, max rotation gap in rad) of two stacks of
    [N, 4, 4] poses."""
    ta, tb = (torch.as_tensor(x, dtype=torch.float64) for x in (a, b))
    dt, dr = se3.gaps((ta[:, :3, :3], ta[:, :3, 3]), (tb[:, :3, :3], tb[:, :3, 3]))
    return float(dt.max()), float(dr.max())


def map_gaps(xyz_a, nrm_a, xyz_b, nrm_b):
    """(share in % of the two maps' points that have no point of the other
    map within MATCH_M; share in % of the matched points whose normals
    disagree: one planar and the other not, or |cos| < 0.99)."""
    if xyz_a.shape[0] == 0 or xyz_b.shape[0] == 0:
        return 100.0, 100.0
    a, b = xyz_a.double(), xyz_b.double()
    _, ia = reference.knn(a, b, 1, MATCH_M ** 2, reference.FLOAT64)
    _, ib = reference.knn(b, a, 1, MATCH_M ** 2, reference.FLOAT64)
    unmatched = int((ia < 0).sum()) + int((ib < 0).sum())
    ok = ia[:, 0] >= 0
    na, nb = nrm_a[ok].double(), nrm_b[ia[ok, 0]].double()
    pa, pb = (na * na).sum(1) > 0.25, (nb * nb).sum(1) > 0.25
    cos = (na * nb).sum(1).abs()
    bad = (pa != pb) | (pa & pb & (cos < 0.99))
    share_map = 100.0 * unmatched / (a.shape[0] + b.shape[0])
    share_nrm = 100.0 * int(bad.sum()) / max(int(ok.sum()), 1)
    return share_map, share_nrm


def odometry_numbers(prog: dict, ref: dict) -> dict:
    """One odometry pass: poses, ICP iterations and the final map."""
    dt, dr = pose_gaps(prog["poses"], ref["poses"])
    its = np.abs(np.asarray(prog["iterations"]) - np.asarray(ref["iterations"]))
    dev = ref["map"][0].device
    share_map, share_nrm = map_gaps(prog["map"][0].to(dev), prog["map"][1].to(dev),
                                    ref["map"][0], ref["map"][1])
    return {"pose_gap_m": dt, "rot_gap_rad": dr, "iter_gap": float(its.max(initial=0)),
            "map_gap_pct": share_map, "normals_gap_pct": share_nrm}


def align_numbers(prog: list, ref: list) -> dict:
    """Aligns: (R, t, iterations, reason, pairs of the last iteration) each.
    ``pairs_gap_pct`` is the largest gap of the pairs, in % of the
    reference's: it sees which of a scan's points the align used, which a
    pose that lands within millimetres does not show."""
    def stack(xs):
        m = np.tile(np.eye(4), (len(xs), 1, 1))
        for i, x in enumerate(xs):
            m[i, :3, :3], m[i, :3, 3] = np.asarray(x[0], np.float64), np.asarray(x[1], np.float64)
        return m

    dt, dr = pose_gaps(stack(prog), stack(ref))
    its = max(abs(int(p[2]) - int(r[2])) for p, r in zip(prog, ref))
    reasons = sum(p[3] != r[3] for p, r in zip(prog, ref))
    pairs = max(100.0 * abs(int(p[4]) - int(r[4])) / max(int(r[4]), 1) for p, r in zip(prog, ref))
    return {"pose_gap_m": dt, "rot_gap_rad": dr, "iter_gap": float(its),
            "reason_gap": float(reasons), "pairs_gap_pct": pairs}


def worst(numbers: list) -> dict:
    """The largest of each number over several comparisons."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}


def judge(numbers: dict, limits: dict):
    """(correct, [(name, value, limit)]): every number that has a limit is
    at or under it; a cell without limits is not correct."""
    rows = [(k, numbers.get(k), v) for k, v in sorted(limits.items())]
    ok = bool(rows) and all(val is not None and np.isfinite(val) and val <= lim
                            for _, val, lim in rows)
    return ok, rows
