"""The benchmark's inputs, made on the device from a seed.

Frozen copies, so that a change to the program cannot move the yardstick:

- the street drive: ``make_street_scene``, ``render_spinning_scan``,
  ``_se3_exp_batch`` and ``make_street_sequence`` of
  mp2p_icp_tpu_torch/eval/lidar_sim.py (bench.py:580-620), rewritten to cast
  the rays with torch in float64 on the device;
- the corridor map and its scans: ``corridor_scene``, ``local_window`` and
  ``sensor_scan`` of bench_torch.py (bench.py:349-385, :436-451), drawn
  with a torch.Generator on the device.

What the seed decides: the sensor's range noise and the IMU's twist noise
of the drive, the corridor's points, the scans' points and their guess
errors. The scene's layout (walls, the pillars of ``scene_seed``) and the
trajectory are the configuration's, the same for every seed, so that every
seed asks for the same work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import se3

RING_ELEV_TOP_DEG = 2.0  # the HDL-64E's elevation span
RING_ELEV_BOT_DEG = -24.8
_BIG = 1e9
PAD_VALUE = 1.0e8  # the program's padding coordinate


def generators(seed: int, device):
    """(host generator, device generator) of ``seed`` (any integer below
    2**63)."""
    host = torch.Generator().manual_seed(seed)
    dev = torch.Generator(device=device).manual_seed(seed)
    return host, dev


# ------------------------------------------------------------ the street
def make_street_scene(rng: np.random.RandomState, length: float, width: float = 14.0,
                      n_pillars: int = 40, cross_walls_every: float = 50.0):
    """(walls, cylinders) of a street corridor along +x: side walls,
    staggered cross-wall facades every ``cross_walls_every`` m and pillars
    off the drive lane |y| < 1.5 (lidar_sim.make_street_scene, draw for
    draw)."""
    half = width / 2.0
    walls = [(1, -half, -10.0, length + 10.0, 0.0, 5.0),
             (1, half, -10.0, length + 10.0, 0.0, 5.0)]
    x, side = cross_walls_every, 1
    while x < length:
        walls.append((0, x, 0.2, half, 0.0, 4.0) if side > 0 else (0, x, -half, -0.2, 0.0, 4.0))
        side = -side
        x += cross_walls_every
    cylinders = []
    for _ in range(n_pillars):
        cx = rng.uniform(0.0, length)
        cy = rng.uniform(-half + 0.8, half - 0.8)
        if abs(cy) < 1.5:
            cy = np.sign(cy or 1.0) * rng.uniform(1.8, half - 0.8)
        cylinders.append((cx, cy, rng.uniform(0.12, 0.4), rng.uniform(2.0, 4.5)))
    return walls, cylinders


def ray_cast(walls, cylinders, o: torch.Tensor, d: torch.Tensor):
    """First-hit range [N] (BIG where none) and surface id [N] (0 ground,
    1 + i wall i, 1 + len(walls) + j cylinder j, -1 none) of rays o + s d."""
    best = torch.full(o.shape[:1], _BIG, dtype=o.dtype, device=o.device)
    sid = torch.full(o.shape[:1], -1, dtype=torch.int32, device=o.device)

    def take(hit, s, ident):
        nonlocal best, sid
        hit = hit & (s > 0.05) & (s < best)
        best = torch.where(hit, s, best)
        sid = torch.where(hit, torch.full_like(sid, ident), sid)

    dz = d[:, 2]
    take(dz < -1e-9, -o[:, 2] / torch.where(dz == 0, 1e-30, dz), 0)
    for i, (axis, pos, lo, hi, z0, z1) in enumerate(walls):
        da = d[:, axis]
        s = (pos - o[:, axis]) / torch.where(da == 0, 1e-30, da)
        p = o + s[:, None] * d
        other = 1 - axis
        take((da.abs() > 1e-9) & (p[:, other] >= lo) & (p[:, other] <= hi)
             & (p[:, 2] >= z0) & (p[:, 2] <= z1), s, 1 + i)
    for j, (cx, cy, r, h) in enumerate(cylinders):
        ox, oy = o[:, 0] - cx, o[:, 1] - cy
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        b = 2.0 * (ox * d[:, 0] + oy * d[:, 1])
        c = ox * ox + oy * oy - r * r
        disc = b * b - 4.0 * a * c
        s = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * torch.clamp(a, min=1e-30))
        z = o[:, 2] + s * d[:, 2]
        take((disc > 0) & (a > 1e-12) & (z >= 0.0) & (z <= h), s, 1 + len(walls) + j)
    return best, sid


def render_spinning_scan(walls, cylinders, pose0, twist: torch.Tensor, gen: torch.Generator,
                         n_rings: int, n_azimuth: int, max_range: float = 75.0,
                         range_noise: float = 0.02, period: float = 0.1):
    """One revolution from ``pose0`` = (R, t) float64 moving with the body
    twist ``twist`` [6] during the sweep, each return recorded in the sensor
    frame of mid-sweep as if the sensor had not moved (the distortion that
    a deskew undoes); rays ring-major, Gaussian range noise from ``gen``.
    Returns dict(xyz [M, 3] f32 (PAD_VALUE where no return), ring, time,
    intensity [M] f32, valid [M] bool) on ``gen``'s device."""
    dev, f64 = gen.device, torch.float64
    elev = torch.deg2rad(torch.linspace(RING_ELEV_TOP_DEG, RING_ELEV_BOT_DEG, n_rings,
                                        dtype=f64, device=dev))
    col = (torch.arange(n_azimuth, dtype=f64, device=dev) + 0.5) / n_azimuth
    az = -math.pi + 2.0 * math.pi * col
    t_rel = period * (col - 0.5)
    ce, sel = torch.cos(elev), torch.sin(elev)
    d_sens = torch.stack([torch.cos(az)[:, None] * ce[None, :],
                          torch.sin(az)[:, None] * ce[None, :],
                          sel[None, :].expand(n_azimuth, n_rings)], -1)  # [A, R, 3]
    Rd, td = se3.exp(t_rel[:, None] * twist.to(dev, f64)[None, :])
    R0, t0 = pose0[0].to(dev, f64), pose0[1].to(dev, f64)
    R_t, t_t = R0 @ Rd, (R0 @ td[..., None])[..., 0] + t0
    d_world = torch.einsum("aij,arj->ari", R_t, d_sens)
    o_world = t_t[:, None, :].expand_as(d_world)
    rng_hit, sid = ray_cast(walls, cylinders, o_world.reshape(-1, 3), d_world.reshape(-1, 3))
    rng_hit = rng_hit + range_noise * torch.randn(rng_hit.shape, generator=gen, dtype=f64,
                                                  device=dev)
    valid = (sid >= 0) & (rng_hit > 0.5) & (rng_hit < max_range)
    xyz = rng_hit.reshape(n_azimuth, n_rings, 1) * d_sens
    base = torch.where(sid == 0, 0.25, torch.where(sid <= len(walls), 0.55, 0.85))
    inten = torch.clamp(base * (1.0 - 0.8 * rng_hit / max_range)
                        + 0.03 * torch.randn(sid.shape, generator=gen, dtype=f64, device=dev),
                        0.0, 1.0)

    def ring_major(a):
        return a.reshape(n_azimuth, n_rings, -1).transpose(0, 1).reshape(n_azimuth * n_rings, -1)

    ring = torch.arange(n_rings, dtype=f64, device=dev)[None, :].expand(n_azimuth, n_rings)
    tm = t_rel[:, None].expand(n_azimuth, n_rings)
    v = ring_major(valid.reshape(n_azimuth, n_rings))[:, 0]
    return {"xyz": torch.where(v[:, None], ring_major(xyz), PAD_VALUE).float(),
            "ring": ring_major(ring)[:, 0].float(), "time": ring_major(tm)[:, 0].float(),
            "intensity": torch.where(v, ring_major(inten.reshape(n_azimuth, n_rings))[:, 0],
                                     0.0).float(),
            "valid": v}


def street_drive(cfg: dict, n_frames: int, seed: int, device):
    """The street drive of ``cfg["drive"]`` and ``cfg["sensor"]``: a
    vehicle along the street at ``speed`` m/s, weaving and yawing, one
    revolution per ``period`` s (make_street_sequence).

    Returns (gt [N, 4, 4] float64 numpy, twists [N, 6] float32 numpy: the
    IMU's body twists with scale and bias noise from the seed, scans: N
    dicts as ``render_spinning_scan`` gives them, on ``device``)."""
    drv, sen = cfg["drive"], cfg["sensor"]
    dt = sen["period_s"]
    walls, cylinders = make_street_scene(np.random.RandomState(drv["scene_seed"]),
                                         length=drv["street_length_m"],
                                         n_pillars=drv["pillars"])
    host, dev_gen = generators(seed, device)
    poses = [se3.from_xyz_ypr(drv["start_x_m"] + drv["speed_m_s"] * dt * i,
                              drv["weave_m"] * math.sin(0.15 * i), drv["height_m"],
                              drv["yaw_rad"] * math.sin(0.2 * i), 0.0, 0.0)
             for i in range(n_frames)]
    true_tw = []
    for i in range(n_frames):
        if i < n_frames - 1:
            rel = se3.compose(se3.inverse(poses[i]), poses[i + 1])
            true_tw.append(se3.log(*rel) / dt)
        else:
            true_tw.append(true_tw[-1])
    scans = [render_spinning_scan(walls, cylinders, poses[i], true_tw[i], dev_gen,
                                  sen["rings"], sen["azimuths"], sen["max_range_m"],
                                  sen["range_noise_m"], dt)
             for i in range(n_frames)]
    bias = torch.tensor(drv["imu_bias"], dtype=torch.float64)
    twists = [tw * (1.0 + drv["imu_scale_noise"] * torch.randn(6, generator=host,
                                                               dtype=torch.float64))
              + bias * torch.randn(6, generator=host, dtype=torch.float64) for tw in true_tw]
    gt = np.tile(np.eye(4), (n_frames, 1, 1))
    for i, (R, t) in enumerate(poses):
        gt[i, :3, :3], gt[i, :3, 3] = R.numpy(), t.numpy()
    return gt, torch.stack(twists).float().numpy(), scans


def compact_scan(scan: dict, capacity: int) -> dict:
    """The valid returns of a rendered scan leading, in firing order, in
    buffers of ``capacity`` rows (PAD_VALUE / 0 beyond): the raw frame as
    both sides receive it. Returns dict(xyz, intensity, ring, time, count)."""
    v = scan["valid"]
    n = int(v.sum())
    if n > capacity:
        raise ValueError(f"{n} returns do not fit the raw capacity {capacity}")
    out = {"count": n}
    for key, fill in (("xyz", PAD_VALUE), ("intensity", 0.0), ("ring", 0.0), ("time", 0.0)):
        src = scan[key][v]
        buf = torch.full((capacity,) + src.shape[1:], fill, dtype=torch.float32,
                         device=src.device)
        buf[:n] = src
        out[key] = buf
    return out


# ----------------------------------------------------------- the corridor
def corridor_scene(n: int, length: float, gen: torch.Generator) -> torch.Tensor:
    """[n, 3] float32: a corridor along x, ground + side walls at y = +-6 +
    cross-walls every 25 m, so every SE(3) axis is constrained locally
    (bench.py:349-365, drawn on ``gen``'s device)."""
    dev = gen.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, dtype=torch.float64, device=dev)

    t = uniform(0.0, length)
    kind = torch.randint(0, 4, (n,), generator=gen, device=dev)
    y = torch.where(kind == 0, -6.0, torch.where(kind == 1, 6.0, uniform(-6.0, 6.0)))
    z = torch.where(kind < 2, uniform(0.0, 4.0),
                    torch.where(kind == 2, 0.0, uniform(0.0, 2.5)))
    x = torch.where(kind == 3, torch.round(t / 25.0) * 25.0, t)
    return torch.stack([x, y, z], 1).float()


def sensor_scan(corridor: torch.Tensor, cx: float, err, n: int, radius: float,
                noise: float, height: float, gen: torch.Generator):
    """One scan of the corridor seen from x = cx: n points of the corridor
    within ``radius`` of x = cx, with Gaussian noise, in the frame of the
    true sensor pose = sensor o err (bench.py:374-385, :436-451).
    Returns (scan [n, 3] float32 in the sensor frame, guess = the sensor's
    nominal pose, truth), poses as float64 (R, t) on the host."""
    rows = torch.nonzero(torch.abs(corridor[:, 0] - cx) < radius)[:, 0]
    pick = rows[torch.randperm(rows.shape[0], generator=gen, device=rows.device)[:n]]
    pts = corridor[pick].double() + noise * torch.randn((n, 3), generator=gen,
                                                        dtype=torch.float64, device=rows.device)
    sensor = se3.from_xyz_ypr(cx, 0.0, height, 0.0, 0.0, 0.0)
    truth = se3.compose(sensor, se3.from_xyz_ypr(*err))
    inv = se3.inverse(truth)
    local = se3.apply((inv[0].to(pts.device), inv[1].to(pts.device)), pts)
    return local.float(), sensor, truth
