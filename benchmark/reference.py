"""The plain reference of the benchmark's cells: the same semantics as the
program's entry points, written again in plain PyTorch.

It imports neither jax nor anything of mp2p_icp_tpu or mp2p_icp_tpu_torch,
and takes nothing that the program made: it starts from the raw frames,
twists, maps and scans that the benchmark generated, and works out the
deskewed and decimated clouds, the crops, the voxel map, its normals and
every pose again. It works on compact arrays of the valid rows (no padding),
in the precision it is given:

- ``FLOAT64``: the yardstick;
- ``TF32``: the control, float32 with every matrix product's operands
  rounded to TF32's 10-bit mantissa (and TF32 allowed on the card), the
  step below the float32-with-TF32-off that the configurations state. Its
  kNN is the matrix-product form |q|^2 + |p|^2 - 2 q.p, the form a
  tensor-core kNN would take.

What it follows (the program's documented behaviour, as the configuration
files set it):

- deskew: each return moved by exp(time * twist) (FilterDeskew,
  constant twist);
- FirstPoint decimation: per voxel floor(p / res) the return of the lowest
  row, the voxels in lexicographic (x, y, z) cell order, the first
  ``capacity`` of them kept;
- the crop of a large map at the guess: the map rows inside the box of
  the transformed scan grown by the matcher's radius + margin, every
  stride-th of them (stride = ceil(inside / capacity)) in map order, at
  most ``capacity``;
- the voxel map: one point per voxel, the earliest inserted; a frame's
  new voxels go in row order, each won by its lowest row; rows past the
  capacity are dropped and leave their voxel open;
- normals of the new map points (the first ``query_capacity`` of a
  frame): the k nearest of the cropped map + the frame's scan within the
  radius; at least 4, and planar (l0 < threshold * l2), else none;
- the ICP loop: matchers, solvers by iteration window, the step / rotation
  stall test against the last two poses, ``max_iterations``; point to plane
  on stored normals with Gauss-Newton; point to point within a threshold,
  one local point per map point (the closest), Horn then Gauss-Newton.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark import se3

OFFSET = 1 << 14  # voxel cells per axis on each side of the origin


class Precision(NamedTuple):
    dtype: torch.dtype
    tf32: bool


FLOAT64 = Precision(torch.float64, False)
TF32 = Precision(torch.float32, True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    if prec.tf32:
        a, b = tf32_round(a), tf32_round(b)
    return a @ b


def transform(pose, pts: torch.Tensor, prec: Precision) -> torch.Tensor:
    R, t = pose
    return mm(pts, R.transpose(0, 1).contiguous(), prec) + t


# --------------------------------------------------------------------- kNN
def knn(q: torch.Tensor, p: torch.Tensor, k: int, radius_sq: float, prec: Precision,
        chunk: int = 1024):
    """k nearest rows of p [C, 3] for each row of q [Q, 3], by the matrix
    product form. Returns (d2 [Q, k], idx [Q, k] int64, -1 where none lies
    within radius_sq (strictly)."""
    Q, C = q.shape[0], p.shape[0]
    kk = min(k, C)
    d_out = torch.full((Q, k), float("inf"), dtype=q.dtype, device=q.device)
    i_out = torch.full((Q, k), -1, dtype=torch.int64, device=q.device)
    if kk == 0 or Q == 0:
        return d_out, i_out
    pn = (p * p).sum(1)
    pt = p.transpose(0, 1).contiguous()
    for s in range(0, Q, chunk):
        qs = q[s:s + chunk]
        d2 = (qs * qs).sum(1)[:, None] + pn[None, :] - 2.0 * mm(qs, pt, prec)
        if kk == 1:
            d, i = d2.min(1, keepdim=True)
        else:
            d, i = torch.topk(d2, kk, dim=1, largest=False, sorted=True)
        d_out[s:s + chunk, :kk], i_out[s:s + chunk, :kk] = d, i
        del d2
    ok = d_out < radius_sq
    return torch.where(ok, d_out, float("inf")), torch.where(ok, i_out, -1)


# ----------------------------------------------------------------- filters
def deskew(xyz: torch.Tensor, time: torch.Tensor, twist: torch.Tensor) -> torch.Tensor:
    """Each point p at relative time s moved to exp(s * twist) p."""
    R, t = se3.exp(time[:, None] * twist[None, :])
    return (R @ xyz[..., None])[..., 0] + t


def voxel_keys(xyz: torch.Tensor, res: float) -> torch.Tensor:
    """int64 key of floor(p / res), ordered as the (x, y, z) cells."""
    c = torch.clamp(torch.floor(xyz / res), -OFFSET, OFFSET - 1).to(torch.int64) + OFFSET
    return (c[:, 0] << 30) | (c[:, 1] << 15) | c[:, 2]


def first_per_key(key: torch.Tensor) -> torch.Tensor:
    """[N] bool: the lowest row of each distinct key."""
    uniq, inv = torch.unique(key, return_inverse=True)
    first = torch.full(uniq.shape, key.shape[0], dtype=torch.int64, device=key.device)
    first = first.scatter_reduce(0, inv, torch.arange(key.shape[0], device=key.device), "amin")
    win = torch.zeros(key.shape[0], dtype=torch.bool, device=key.device)
    win[first] = True
    return win


def decimate_first_point(xyz: torch.Tensor, res: float, capacity: int):
    """(rows of the winners in voxel order, first ``capacity`` of them;
    number of voxels)."""
    key = voxel_keys(xyz, res)
    win = torch.nonzero(first_per_key(key))[:, 0]
    order = torch.argsort(key[win], stable=True)
    return win[order][:capacity], int(win.shape[0])


def crop(map_xyz: torch.Tensor, scan_world: torch.Tensor, margin: float, capacity: int):
    """(rows of the map kept by the crop, in map order; rows inside the box)."""
    lo = scan_world.min(0).values - margin
    hi = scan_world.max(0).values + margin
    inside = torch.all((map_xyz >= lo) & (map_xyz <= hi), dim=1)
    total = int(inside.sum())
    stride = max((total + capacity - 1) // capacity, 1)
    rows = torch.nonzero(inside)[:, 0]
    return rows[::stride][:capacity], total


# ------------------------------------------------------------------ normals
def fit_normals(q: torch.Tensor, cand: torch.Tensor, k: int, radius: float,
                threshold: float, prec: Precision) -> torch.Tensor:
    """[Q, 3] normals (0 where the neighbourhood is not planar or holds
    fewer than 4 points) from the k nearest of cand within radius."""
    d2, idx = knn(q, cand, k, radius * radius, prec)
    ok = idx >= 0
    pts = cand[torch.clamp(idx, min=0)]
    w = ok.to(q.dtype)
    n = w.sum(1)
    mean = (pts * w[..., None]).sum(1) / torch.clamp(n, min=1.0)[:, None]
    c = (pts - mean[:, None, :]) * w[..., None]
    cov = mm(c.transpose(1, 2), c, prec) / torch.clamp(n, min=1.0)[:, None, None]
    evals, evecs = torch.linalg.eigh(cov)
    planar = (n >= 4) & (evals[:, 0] < threshold * evals[:, 2])
    return torch.where(planar[:, None], evecs[:, :, 0], 0.0)


# ------------------------------------------------------------------ solvers
def gauss_newton(pose, J_res, n_inner: int, prec: Precision, min_delta: float = 1e-7,
                 damping: float = 1e-9):
    """``n_inner`` Gauss-Newton steps pose <- pose o exp(delta) with
    H delta = -g from J_res(pose) = (J [M, 6], r [M]); a step below
    min_delta ends the iterations after it is taken."""
    eye = torch.eye(6, dtype=pose[1].dtype, device=pose[1].device)
    for _ in range(n_inner):
        J, r = J_res(pose)
        H = mm(J.transpose(0, 1).contiguous(), J, prec)
        g = mm(J.transpose(0, 1).contiguous(), r[:, None], prec)[:, 0]
        delta = -torch.linalg.solve(H + damping * eye, g)
        if not bool(torch.isfinite(delta).all()):
            delta = torch.zeros_like(delta)
        pose = se3.compose(pose, se3.exp(delta))
        if float(torch.linalg.vector_norm(delta)) < min_delta:
            break
    return pose


def point_jacobian(R: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """d(R (l + rho + theta x l) + t) / d[rho, theta] at 0: [C, 3, 6]."""
    Rb = R.expand(local.shape[0], 3, 3)
    return torch.cat([Rb, -Rb @ se3.hat(local)], dim=2)


def pt2pt_terms(local, globl, prec):
    def J_res(pose):
        r = transform(pose, local, prec) - globl
        return point_jacobian(pose[0], local).reshape(-1, 6), r.reshape(-1)
    return J_res


def pt2pl_terms(local, centroid, normal, prec):
    def J_res(pose):
        e = ((transform(pose, local, prec) - centroid) * normal).sum(1)
        J = (normal[:, None, :] @ point_jacobian(pose[0], local))[:, 0, :]
        return J, e
    return J_res


def horn(local: torch.Tensor, globl: torch.Tensor, prec: Precision):
    """Horn's closed form: the rotation of the dominant eigenvector of the
    4x4 N matrix of S = sum (l - cl)(g - cg)^T, t = cg - R cl."""
    cl, cg = local.mean(0), globl.mean(0)
    r, b = local - cl, globl - cg
    S = mm(r.transpose(0, 1).contiguous(), b, prec) / local.shape[0]
    Sxx, Sxy, Sxz, Syx, Syy, Syz, Szx, Szy, Szz = S.reshape(-1)
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx]),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz]),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy]),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz]),
    ])
    w, x, y, z = torch.linalg.eigh(N)[1][:, -1]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]),
    ])
    return R, cg - R @ cl


def one_to_one(idx: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[Q] bool: the valid pairs (idx >= 0) that are the closest claim on
    their map point (ties: the lowest local row)."""
    ok = idx >= 0
    rows = torch.nonzero(ok)[:, 0]
    if rows.numel() == 0:
        return ok
    by_d = rows[torch.argsort(d2[rows], stable=True)]
    perm = by_d[torch.argsort(idx[by_d], stable=True)]
    head = torch.ones_like(perm, dtype=torch.bool)
    head[1:] = idx[perm][1:] != idx[perm][:-1]
    out = torch.zeros_like(ok)
    out[perm[head]] = True
    return out


# ----------------------------------------------------------------- ICP loop
def icp_loop(guess, step, max_iterations: int, min_step_t: float, min_step_r: float):
    """The ICP loop: ``step(iteration, pose)`` gives the new pose or None
    when there are no pairs. Returns (pose, iterations, reason), reason in
    {"no_pairings", "solver_error", "stalled", "max_iterations"}."""
    pose = prev = guess
    it = 0
    while it < max_iterations:
        new = step(it, pose)
        it += 1
        if new is None:
            return pose, it, "no_pairings"
        if not (bool(torch.isfinite(new[0]).all()) and bool(torch.isfinite(new[1]).all())):
            return pose, it, "solver_error"
        d1 = se3.log(*se3.compose(se3.inverse(pose), new))
        d2 = se3.log(*se3.compose(se3.inverse(prev), new))
        stalled = any(float(torch.linalg.vector_norm(d[:3])) < min_step_t
                      and float(torch.linalg.vector_norm(d[3:])) < min_step_r for d in (d1, d2))
        prev, pose = pose, new
        if stalled:
            return pose, it, "stalled"
    return pose, it, "max_iterations"


# -------------------------------------------------------------- localization
def align_to_map(map_xyz: torch.Tensor, scan: torch.Tensor, guess, icp: dict, prec: Precision):
    """One scan-to-map align (``icp`` as the localization configuration
    gives it). Returns (pose, iterations, reason, rows inside the crop box,
    pairs of the last iteration: those matched at the pose it started from)."""
    dev, dt = map_xyz.device, prec.dtype
    scan = scan.to(dev, dt)
    guess = (guess[0].to(dev, dt), guess[1].to(dev, dt))
    thr = icp["distance_threshold_m"]
    rows, inside = crop(map_xyz, transform(guess, scan, prec),
                        icp["crop_margin_m"] + thr, icp["crop_capacity"])
    gmap = map_xyz[rows].to(dt)
    del rows
    pairs = [0]

    def step(it, pose):
        d2, idx = knn(transform(pose, scan, prec), gmap, 1, thr * thr, prec)
        keep = one_to_one(idx[:, 0], d2[:, 0])
        pairs[0] = int(keep.sum())
        if not pairs[0]:
            return None
        loc, glo = scan[keep], gmap[idx[keep, 0]]
        if it <= icp["horn_up_to_iteration"]:
            return horn(loc, glo, prec)
        return gauss_newton(pose, pt2pt_terms(loc, glo, prec), icp["gn_inner_iterations"], prec)

    pose, its, reason = icp_loop(guess, step, icp["max_iterations"],
                                 icp["min_abs_step_trans"], icp["min_abs_step_rot"])
    return pose, its, reason, inside, pairs[0]


# ------------------------------------------------------------------ odometry
class VoxelMap:
    """One point per voxel, in insertion order, with normals."""

    def __init__(self, capacity: int, res: float, device, dtype):
        self.capacity, self.res = capacity, res
        self.xyz = torch.empty((0, 3), dtype=dtype, device=device)
        self.normals = torch.empty((0, 3), dtype=dtype, device=device)
        self.keys = torch.empty((0,), dtype=torch.int64, device=device)
        self.dropped = 0

    def insert(self, pts: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
        """Insert pts (in row order); returns the rows of pts that entered."""
        key = voxel_keys(pts, self.res)
        new = ~torch.isin(key, self.keys) & first_per_key(key)
        rows = torch.nonzero(new)[:, 0]
        room = max(self.capacity - self.xyz.shape[0], 0)
        self.dropped += max(rows.shape[0] - room, 0)
        rows = rows[:room]
        self.xyz = torch.cat([self.xyz, pts[rows]])
        self.normals = torch.cat([self.normals, normals[rows]])
        self.keys = torch.cat([self.keys, key[rows]])
        return rows


def odometry(frames, twists, pose0, cfg: dict, prec: Precision):
    """The odometry run over ``frames`` (dicts of xyz, time, count: the raw
    frames as generated), ``twists`` [N, 6] (the IMU's) from ``pose0``.
    Returns dict(poses [N, 4, 4] float64 numpy, iterations [N-1],
    reasons, map (xyz, normals), dropped, voxels (decimation voxels per
    frame), crop_inside (map rows inside the crop box per frame))."""
    m = cfg["mapper"]
    dt_s = cfg["sensor"]["period_s"]
    dev, dt = frames[0]["xyz"].device, prec.dtype
    tw = torch.as_tensor(twists, dtype=dt, device=dev)
    res = m["voxel_m"]

    def local(i):
        n = int(frames[i]["count"])
        xyz = deskew(frames[i]["xyz"][:n].to(dt), frames[i]["time"][:n].to(dt), tw[i])
        rows, voxels = decimate_first_point(xyz, res, m["decimated_capacity"])
        return xyz[rows], voxels

    def normals_of(q, cand):
        return fit_normals(q, cand, m["normals_knn"], m["normals_radius_m"],
                           m["normals_eigen_threshold"], prec)

    pose = (pose0[0].to(dev, dt), pose0[1].to(dev, dt))
    src, voxels = local(0)
    world = transform(pose, src, prec)
    vmap = VoxelMap(m["map_capacity"], res, dev, dt)
    vmap.insert(world, normals_of(world, world))
    out = {"poses": [pose], "iterations": [], "reasons": [], "voxels": [voxels],
           "crop_inside": []}
    for i in range(1, len(frames)):
        guess = se3.compose(pose, se3.exp(dt_s * tw[i - 1]))
        src, voxels = local(i)
        if m["map_capacity"] > m["crop_capacity"]:  # the program crops a larger buffer
            rows, inside = crop(vmap.xyz, transform(guess, src, prec),
                                m["crop_margin_m"] + m["distance_threshold_m"], m["crop_capacity"])
        else:
            rows, inside = torch.arange(vmap.xyz.shape[0], device=dev), vmap.xyz.shape[0]
        near, near_n = vmap.xyz[rows], vmap.normals[rows]
        thr = m["distance_threshold_m"]

        def step(it, p):
            d2, idx = knn(transform(p, src, prec), near, 1, thr * thr, prec)
            j = idx[:, 0]
            nrm = near_n[torch.clamp(j, min=0)]
            keep = (j >= 0) & ((nrm * nrm).sum(1) > 0.5)
            if not bool(keep.any()):
                return None
            terms = pt2pl_terms(src[keep], near[j[keep]], nrm[keep], prec)
            return gauss_newton(p, terms, m["gn_inner_iterations"], prec)

        pose, its, reason = icp_loop(guess, step, m["max_iterations"],
                                     m["min_abs_step_trans"], m["min_abs_step_rot"])
        world = transform(pose, src, prec)
        entered = vmap.insert(world, torch.zeros_like(world))
        fit = entered[:m["normals_query_capacity"]]
        first = vmap.xyz.shape[0] - entered.shape[0]
        nq = normals_of(world[fit], torch.cat([near, world]))
        vmap.normals[first:first + fit.shape[0]] = nq
        out["poses"].append(pose)
        out["iterations"].append(its)
        out["reasons"].append(reason)
        out["voxels"].append(voxels)
        out["crop_inside"].append(inside)
    mats = torch.zeros((len(out["poses"]), 4, 4), dtype=torch.float64)
    for i, (R, t) in enumerate(out["poses"]):
        mats[i, :3, :3], mats[i, :3, 3], mats[i, 3, 3] = R.double().cpu(), t.double().cpu(), 1.0
    out["poses"] = mats.numpy()
    out["map"] = (vmap.xyz, vmap.normals)
    out["dropped"] = vmap.dropped
    return out
