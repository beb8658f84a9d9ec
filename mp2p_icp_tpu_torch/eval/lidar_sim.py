"""Synthetic spinning-LiDAR simulator: the structured test and smoke workload.

The port's own copy of ``mp2p_icp_tpu/eval/lidar_sim.py`` (numpy only;
``scan_to_pointcloud`` builds the port's PointCloud). It renders
HDL-64E-style sweeps against an analytic scene (ground plane + vertical
walls + cylindrical pillars):

- rings over the HDL-64E elevation span (+2 .. -24.8 degrees), H azimuth
  columns per revolution;
- per-point azimuth timestamps over the 0.1 s revolution (MiddleIsZero
  convention, matching FilterAdjustTimestamps);
- the sensor moves during the sweep (pose(t) = pose0·exp(t·twist)), and
  each return is expressed in the instantaneous sensor frame, so the cloud
  carries the motion distortion that FilterDeskew (reference:
  FilterDeskew.cpp:69-275, constant-twist model) must undo;
- range-dependent density and occlusion fall out of the ray cast (nearest
  analytic hit per ray), plus Gaussian range noise;
- per-point ring ids and a simple range/incidence intensity model.

All rays of a scan are cast in one vectorised batch on the host.

``render_planar_scan`` renders one sweep of a planar 2D scanner (a Hokuyo
UTM-30LX by default) in the same scenes.

``make_scene`` / ``sample_scan`` are the registration benchmark's unordered
point pool and its sweeps (no ray cast), kept here so that the port's
scripts need nothing of the JAX side.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud

_BIG = 1e9


@dataclasses.dataclass
class Scene:
    """Analytic world: a ground plane at z=0, axis-aligned vertical wall
    rectangles, and vertical cylinders (pillars / trunks / poles)."""

    # (axis, pos, lo, hi, z0, z1): plane {x|y}=pos, the other coord in
    # [lo, hi], z in [z0, z1]
    walls: List[Tuple[int, float, float, float, float, float]]
    # (cx, cy, radius, height)
    cylinders: List[Tuple[float, float, float, float]]
    ground_z: float = 0.0

    def ray_cast(self, origins: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        """First-hit distance per ray ([N, 3] origins/dirs) — occlusion is
        the min over all primitives. Returns [N] ranges (BIG = no hit) and
        [N] surface ids (0 ground, 1+i wall i, 1+len(walls)+j cylinder j)."""
        n = origins.shape[0]
        best = np.full(n, _BIG, np.float64)
        sid = np.full(n, -1, np.int32)

        # ground plane z = ground_z
        dz = dirs[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (self.ground_z - origins[:, 2]) / dz
        hit = (dz < -1e-9) & (t > 0.05) & (t < best)
        best = np.where(hit, t, best)
        sid = np.where(hit, 0, sid)

        for i, (axis, pos, lo, hi, z0, z1) in enumerate(self.walls):
            da = dirs[:, axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (pos - origins[:, axis]) / da
            p = origins + t[:, None] * dirs
            other = 1 - axis
            hit = (
                (np.abs(da) > 1e-9)
                & (t > 0.05)
                & (p[:, other] >= lo)
                & (p[:, other] <= hi)
                & (p[:, 2] >= z0)
                & (p[:, 2] <= z1)
                & (t < best)
            )
            best = np.where(hit, t, best)
            sid = np.where(hit, 1 + i, sid)

        nw = len(self.walls)
        for j, (cx, cy, r, h) in enumerate(self.cylinders):
            ox = origins[:, 0] - cx
            oy = origins[:, 1] - cy
            dx, dy = dirs[:, 0], dirs[:, 1]
            a = dx * dx + dy * dy
            b = 2.0 * (ox * dx + oy * dy)
            c = ox * ox + oy * oy - r * r
            disc = b * b - 4.0 * a * c
            with np.errstate(divide="ignore", invalid="ignore"):
                sq = np.sqrt(np.maximum(disc, 0.0))
                t = (-b - sq) / (2.0 * a)
            z = origins[:, 2] + t * dirs[:, 2]
            hit = (
                (disc > 0)
                & (a > 1e-12)
                & (t > 0.05)
                & (z >= 0.0)
                & (z <= h)
                & (t < best)
            )
            best = np.where(hit, t, best)
            sid = np.where(hit, 1 + nw + j, sid)
        return best, sid


def make_street_scene(
    rng: np.random.RandomState,
    length: float = 200.0,
    width: float = 14.0,
    n_pillars: int = 40,
    cross_walls_every: float = 50.0,
) -> Scene:
    """A street corridor along +x: side walls, periodic cross-wall façades
    (so x is locally constrained), and pillars (trees/poles) near the
    walls — every SE(3) axis observable from any sensor pose inside."""
    half = width / 2.0
    walls = [
        (1, -half, -10.0, length + 10.0, 0.0, 5.0),
        (1, half, -10.0, length + 10.0, 0.0, 5.0),
    ]
    x = cross_walls_every
    side = 1
    while x < length:
        # staggered half-width façades jutting into the corridor
        if side > 0:
            walls.append((0, x, 0.2, half, 0.0, 4.0))
        else:
            walls.append((0, x, -half, -0.2, 0.0, 4.0))
        side = -side
        x += cross_walls_every
    cylinders = []
    for _ in range(n_pillars):
        cx = rng.uniform(0.0, length)
        cy = rng.uniform(-half + 0.8, half - 0.8)
        # keep the drive lane |y|<1.5 clear
        if abs(cy) < 1.5:
            cy = np.sign(cy or 1.0) * rng.uniform(1.8, half - 0.8)
        cylinders.append(
            (cx, cy, rng.uniform(0.12, 0.4), rng.uniform(2.0, 4.5))
        )
    return Scene(walls=walls, cylinders=cylinders)


def make_scene(rng: np.random.RandomState, n: int = 200_000, extent: float = 60.0) -> np.ndarray:
    """The registration benchmark's point pool (the port's copy of
    ``make_scene`` of bench.py, draw for draw): a dense structured street
    scene, noisy ground plus wall planes in both orientations, so every
    translation axis is constrained. Returns [n, 3] float32."""
    ground = np.stack([rng.uniform(-extent, extent, n // 2),
                       rng.uniform(-extent, extent, n // 2),
                       np.zeros(n // 2)], 1)
    walls_y = np.stack([rng.uniform(-extent, extent, n // 4),
                        rng.choice([-20.0, -10.0, 10.0, 20.0], n // 4),
                        rng.uniform(0, 4, n // 4)], 1)
    walls_x = np.stack([rng.choice([-25.0, -15.0, 15.0, 25.0], n // 4),
                        rng.uniform(-extent, extent, n // 4),
                        rng.uniform(0, 4, n // 4)], 1)
    return np.concatenate([ground, walls_y, walls_x]).astype(np.float32)


def sample_scan(scene: np.ndarray, rng: np.random.RandomState, n: int = 8192,
                noise: float = 0.02) -> np.ndarray:
    """One sensor sweep of ``make_scene``'s pool (the port's copy of
    ``sample_scan`` of bench.py): an independent random subset plus
    per-scan Gaussian noise, so every scan sees different points."""
    idx = rng.choice(scene.shape[0], size=n, replace=False)
    return (scene[idx] + noise * rng.randn(n, 3)).astype(np.float32)


# HDL-64E-style elevation span
RING_ELEV_TOP_DEG = 2.0
RING_ELEV_BOT_DEG = -24.8


def render_spinning_scan(
    scene: Scene,
    pose0,
    twist: np.ndarray,
    rng: np.random.RandomState,
    n_rings: int = 64,
    n_azimuth: int = 1024,
    max_range: float = 75.0,
    range_noise: float = 0.02,
    period: float = 0.1,
):
    """One revolution of a spinning scanner starting at ``pose0`` (core.se3
    Pose) and moving with constant ``twist`` [vx vy vz wx wy wz] (world-rate
    in the BODY frame, the FilterDeskew convention) during the sweep.

    Returns dict(xyz [M,3] f32, ring [M] f32, time [M] f32, intensity [M]
    f32, valid [M] bool) with M = n_rings*n_azimuth; xyz is the RAW
    (motion-distorted) cloud in the sensor frame of the scan REFERENCE time
    (t=0 at mid-sweep — the MiddleIsZero convention): a point measured at
    time t is range·d in the pose(t) frame but recorded as if the sensor
    had never moved, exactly what a naive acquisition loop accumulates and what
    FilterDeskew's exp(t·twist) correction undoes."""
    elev = np.deg2rad(
        np.linspace(RING_ELEV_TOP_DEG, RING_ELEV_BOT_DEG, n_rings)
    )
    az = -np.pi + 2.0 * np.pi * (np.arange(n_azimuth) + 0.5) / n_azimuth
    t_rel = period * ((np.arange(n_azimuth) + 0.5) / n_azimuth - 0.5)

    # sensor-frame ray directions [A, R, 3]
    ce, se_ = np.cos(elev), np.sin(elev)
    ca, sa = np.cos(az), np.sin(az)
    d_sens = np.stack(
        [
            ca[:, None] * ce[None, :],
            sa[:, None] * ce[None, :],
            np.broadcast_to(se_[None, :], (n_azimuth, n_rings)),
        ],
        axis=-1,
    )

    # pose at each azimuth column: pose0 · exp(t · twist)
    tw = np.asarray(twist, np.float64)
    R0 = np.asarray(pose0.R.cpu(), np.float64)
    t0 = np.asarray(pose0.t.cpu(), np.float64)
    tangents = t_rel[:, None] * tw[None, :]  # [A, 6]
    Rd, td = _se3_exp_batch(tangents)
    R_t = R0 @ Rd  # [A, 3, 3]
    t_t = (R0 @ td[..., None])[..., 0] + t0  # [A, 3]

    d_world = np.einsum("aij,arj->ari", R_t, d_sens)  # [A, R, 3]
    o_world = np.broadcast_to(t_t[:, None, :], d_world.shape)

    flat_o = o_world.reshape(-1, 3)
    flat_d = d_world.reshape(-1, 3)
    rng_hit, sid = scene.ray_cast(flat_o, flat_d)
    rng_hit = rng_hit + range_noise * rng.randn(rng_hit.shape[0])
    valid = (sid >= 0) & (rng_hit > 0.5) & (rng_hit < max_range)

    # record range·d in the instantaneous sensor frame (the raw cloud)
    xyz = rng_hit.reshape(n_azimuth, n_rings)[..., None] * d_sens
    # incidence-flavoured intensity: surface class base + range falloff
    base = np.where(sid == 0, 0.25, np.where(sid <= len(scene.walls), 0.55, 0.85))
    inten = np.clip(
        base * (1.0 - 0.8 * rng_hit / max_range)
        + 0.03 * rng.randn(sid.shape[0]),
        0.0,
        1.0,
    )
    ring = np.broadcast_to(
        np.arange(n_rings, dtype=np.float32)[None, :], (n_azimuth, n_rings)
    )
    time = np.broadcast_to(
        t_rel.astype(np.float32)[:, None], (n_azimuth, n_rings)
    )

    # flatten RING-MAJOR (ring runs contiguous, azimuth==time increasing
    # within each run — an organized range image, the layout ring-segment
    # filters like FilterCurvature expect)
    def rm(a):
        return np.swapaxes(
            a.reshape(n_azimuth, n_rings, -1), 0, 1
        ).reshape(n_azimuth * n_rings, -1)

    xyz_rm = rm(xyz)
    valid_rm = rm(valid.reshape(n_azimuth, n_rings))[:, 0]
    return {
        "xyz": np.where(valid_rm[:, None], xyz_rm, 1e8).astype(np.float32),
        "ring": rm(ring)[:, 0].astype(np.float32),
        "time": rm(time)[:, 0].astype(np.float32),
        "intensity": np.where(
            valid_rm, rm(inten.reshape(n_azimuth, n_rings))[:, 0], 0.0
        ).astype(np.float32),
        "valid": valid_rm,
    }


def render_planar_ranges(
    scene: Scene,
    x: float,
    y: float,
    yaw: float,
    rng: np.random.RandomState,
    n_rays: int = 1081,
    fov_deg: float = 270.0,
    max_range: float = 30.0,
    range_noise: float = 0.01,
    height: float = 1.0,
):
    """One sweep of a planar scanner at (x, y, ``height``) heading ``yaw``
    (rad): ``n_rays`` rays evenly over ``fov_deg`` centred on the heading
    (the Hokuyo UTM-30LX layout by default: 1081 rays over 270°, 0.25°
    apart, 30 m), Gaussian range noise. Returns (ranges [n_rays] float64
    with 0 where a ray has no return within range, bearings [n_rays] rad),
    the fields of a 2D range scan."""
    a = np.deg2rad(np.linspace(-fov_deg / 2.0, fov_deg / 2.0, n_rays))
    dirs = np.stack([np.cos(yaw + a), np.sin(yaw + a), np.zeros_like(a)], axis=-1)
    origins = np.broadcast_to(np.array([x, y, height], np.float64), dirs.shape)
    with np.errstate(invalid="ignore"):  # inf * 0 of rays parallel to a wall
        r, sid = scene.ray_cast(origins, dirs)
    r = r + range_noise * rng.randn(n_rays)
    hit = (sid >= 0) & (r > 0.1) & (r < max_range)
    return np.where(hit, r, 0.0), a


def planar_points(ranges: np.ndarray, bearings: np.ndarray) -> np.ndarray:
    """The returns (range > 0) of a planar scan as [M, 3] float32 points in
    the sensor frame (z = 0), in firing order."""
    r, a = ranges, bearings
    return np.stack([r * np.cos(a), r * np.sin(a), np.zeros_like(r)], axis=-1)[r > 0].astype(
        np.float32)


def render_planar_scan(scene: Scene, x: float, y: float, yaw: float,
                       rng: np.random.RandomState, **kwargs) -> np.ndarray:
    """``render_planar_ranges`` (same arguments) as ``planar_points``."""
    return planar_points(*render_planar_ranges(scene, x, y, yaw, rng, **kwargs))


def scan_to_pointcloud(scan: dict, capacity=None, device=None):
    """Pack a rendered scan into a compacted PointCloud (valid points
    leading — firing order preserved so ring runs stay contiguous — with
    I/R/T channels) on ``device`` (default: the port's default device)."""
    v = scan["valid"]
    return PointCloud.from_numpy(
        scan["xyz"][v],
        capacity=capacity,
        intensity=scan["intensity"][v],
        ring=scan["ring"][v],
        time=scan["time"][v],
        device=device,
    )


def _se3_exp_batch(tangents: np.ndarray):
    """Batched SE(3) exponential [N, 6] (v, w) -> (R [N,3,3], t [N,3]).
    numpy mirror of core.se3.exp (scene synthesis on the host)."""
    v = tangents[:, :3]
    w = tangents[:, 3:]
    th = np.linalg.norm(w, axis=-1)
    small = th < 1e-9
    th_safe = np.where(small, 1.0, th)
    k = w / th_safe[:, None]
    K = np.zeros(tangents.shape[:1] + (3, 3))
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    s = np.sin(th)[:, None, None]
    c = (1 - np.cos(th))[:, None, None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    R = eye + s * K + c * (K @ K)
    R = np.where(small[:, None, None], eye, R)
    # V matrix for the translation part
    with np.errstate(divide="ignore", invalid="ignore"):
        A = ((1 - np.cos(th)) / th_safe**2)[:, None, None]
        B = ((th - np.sin(th)) / th_safe**3)[:, None, None]
    V = eye + A * (K * th_safe[:, None, None]) + B * (
        (K @ K) * (th_safe**2)[:, None, None]
    )
    V = np.where(small[:, None, None], eye, V)
    t = (V @ v[..., None])[..., 0]
    return R, t


def make_street_sequence(
    n_frames: int = 36,
    n_rings: int = 48,
    n_azimuth: int = 768,
    dt: float = 0.1,
):
    """The street drive of the odometry benchmark (bench.py:580-619): a
    vehicle at 10 m/s along a 260 m street with 60 pillars, weaving 0.5 m
    and yawing 0.05 rad, one revolution every ``dt`` seconds.

    Returns (gt [N, 4, 4] float64 poses, twists: N float32 [6] body twists
    with IMU-grade noise (3% scale, 0.05/0.05/0.02 m/s and 0.005 rad/s
    bias draws), scans: N dicts as ``render_spinning_scan`` gives them).
    All numpy, from the one ``RandomState(7)``, so any package can be
    fed the same frames; the poses and twists are made with the port's
    se3 on the CPU."""
    rng = np.random.RandomState(7)
    scene = make_street_scene(rng, length=260.0, n_pillars=60)
    poses = [
        se3.from_xyz_ypr(12.0 + 10.0 * dt * i, 0.5 * np.sin(0.15 * i), 1.7,
                         0.05 * np.sin(0.2 * i), 0.0, 0.0, device="cpu")
        for i in range(n_frames)
    ]
    twists, scans = [], []
    for i in range(n_frames):
        if i < n_frames - 1:
            rel = se3.compose(se3.inverse(poses[i]), poses[i + 1])
            tw = se3.log(rel).numpy().astype(np.float64) / dt
        else:
            tw = twists[-1]
        twists.append(np.asarray(tw, np.float32))
        scans.append(render_spinning_scan(scene, poses[i], twists[i], rng,
                                          n_rings=n_rings, n_azimuth=n_azimuth))
    bias = np.array([0.05, 0.05, 0.02, 0.005, 0.005, 0.005])
    twists = [
        np.asarray(t * (1.0 + 0.03 * rng.randn(6)) + bias * rng.randn(6), np.float32)
        for t in twists
    ]
    gt = np.tile(np.eye(4), (n_frames, 1, 1))
    gt[:, :3, :3] = torch.stack([p.R for p in poses]).numpy()
    gt[:, :3, 3] = torch.stack([p.t for p in poses]).numpy()
    return gt, twists, scans
