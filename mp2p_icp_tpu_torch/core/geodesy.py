"""WGS-84 geodetic <-> ECEF <-> local ENU conversions.

Port of ``mp2p_icp_tpu/core/geodesy.py``, kept as its own copy: the
functions are plain numpy float64 on the host (georeferencing is map
metadata, as in the reference, which stores a WGS-84 anchor and
T_enu_to_map on metric maps, metricmap.cpp:824-929, and leans on
mrpt::topography for the math), so the same inputs give the JAX package's
values to the bit.

- geodetic_to_ecef / ecef_to_geodetic (WGS-84 ellipsoid; the inverse uses
  Bowring's single-iteration formula, ~1e-9 m accurate for |h| < 10 km)
- geodetic_to_enu / enu_to_geodetic about an anchor point
- enu_to_map / map_to_enu applying a map's stored Georeferencing
  (T_enu_to_map), which makes GPS coordinates actionable against map
  coordinates (mm-georef --to-enu / --geodetic-to-map; --to-enu rewrites
  point layers on their device from the same R and t).

Conventions match mrpt::topography: ENU x=east, y=north, z=up; the ENU
frame is tangent at the anchor geodetic point.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# WGS-84 ellipsoid constants
WGS84_A = 6378137.0  # semi-major axis [m]
WGS84_F = 1.0 / 298.257223563  # flattening
WGS84_B = WGS84_A * (1.0 - WGS84_F)  # semi-minor axis
WGS84_E2 = WGS84_F * (2.0 - WGS84_F)  # first eccentricity squared
_EP2 = (WGS84_A**2 - WGS84_B**2) / WGS84_B**2  # second ecc. squared


def geodetic_to_ecef(lat_deg, lon_deg, h) -> np.ndarray:
    """WGS-84 geodetic (degrees, metres) -> ECEF [m]. Vectorised."""
    lat = np.deg2rad(np.asarray(lat_deg, np.float64))
    lon = np.deg2rad(np.asarray(lon_deg, np.float64))
    h = np.asarray(h, np.float64)
    sin_lat, cos_lat = np.sin(lat), np.cos(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat**2)
    x = (n + h) * cos_lat * np.cos(lon)
    y = (n + h) * cos_lat * np.sin(lon)
    z = (n * (1.0 - WGS84_E2) + h) * sin_lat
    return np.stack(np.broadcast_arrays(x, y, z), axis=-1)


def ecef_to_geodetic(xyz) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ECEF [m] -> WGS-84 geodetic (lat deg, lon deg, h m); Bowring."""
    xyz = np.asarray(xyz, np.float64)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    theta = np.arctan2(z * WGS84_A, p * WGS84_B)
    lat = np.arctan2(
        z + _EP2 * WGS84_B * np.sin(theta) ** 3,
        p - WGS84_E2 * WGS84_A * np.cos(theta) ** 3,
    )
    sin_lat = np.sin(lat)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E2 * sin_lat**2)
    h = np.where(
        np.abs(np.cos(lat)) > 1e-10,
        p / np.cos(lat) - n,
        z / np.where(np.abs(sin_lat) > 1e-10, sin_lat, 1.0)
        - n * (1.0 - WGS84_E2),
    )
    return np.rad2deg(lat), np.rad2deg(lon), h


def _enu_rotation(lat_deg, lon_deg) -> np.ndarray:
    """ECEF->ENU rotation at the anchor (rows = east, north, up)."""
    lat = np.deg2rad(float(lat_deg))
    lon = np.deg2rad(float(lon_deg))
    sl, cl = np.sin(lat), np.cos(lat)
    so, co = np.sin(lon), np.cos(lon)
    return np.array(
        [
            [-so, co, 0.0],
            [-sl * co, -sl * so, cl],
            [cl * co, cl * so, sl],
        ],
        np.float64,
    )


def geodetic_to_enu(lat_deg, lon_deg, h, anchor_lat, anchor_lon,
                    anchor_h) -> np.ndarray:
    """Geodetic points -> ENU metres about the anchor geodetic point
    (mrpt::topography::geodeticToENU_WGS84 semantics)."""
    ecef = geodetic_to_ecef(lat_deg, lon_deg, h)
    ecef0 = geodetic_to_ecef(anchor_lat, anchor_lon, anchor_h)
    r = _enu_rotation(anchor_lat, anchor_lon)
    return (ecef - ecef0) @ r.T


def enu_to_geodetic(enu, anchor_lat, anchor_lon, anchor_h):
    """ENU metres about the anchor -> geodetic (lat deg, lon deg, h m)."""
    enu = np.asarray(enu, np.float64)
    r = _enu_rotation(anchor_lat, anchor_lon)
    ecef = geodetic_to_ecef(anchor_lat, anchor_lon, anchor_h) + enu @ r
    return ecef_to_geodetic(ecef)


def _quat_to_rot(q_wxyz) -> np.ndarray:
    w, x, y, z = (float(v) for v in q_wxyz)
    n = np.sqrt(w * w + x * x + y * y + z * z) or 1.0
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def enu_to_map(enu_pts, georef) -> np.ndarray:
    """Apply a map's stored T_enu_to_map (core.metric_map.Georeferencing)
    to ENU points -> map-frame points."""
    r = _quat_to_rot(georef.t_enu_to_map_quat_wxyz)
    t = np.asarray(georef.t_enu_to_map_xyz, np.float64)
    return np.asarray(enu_pts, np.float64) @ r.T + t


def map_to_enu(map_pts, georef) -> np.ndarray:
    r = _quat_to_rot(georef.t_enu_to_map_quat_wxyz)
    t = np.asarray(georef.t_enu_to_map_xyz, np.float64)
    return (np.asarray(map_pts, np.float64) - t) @ r


def geodetic_to_map(lat_deg, lon_deg, h, georef) -> np.ndarray:
    """GPS fix -> map coordinates via the map's georeferencing anchor —
    the end-to-end operation the stored metadata exists for."""
    enu = geodetic_to_enu(
        lat_deg, lon_deg, h,
        georef.latitude, georef.longitude, georef.height,
    )
    return enu_to_map(enu, georef)


def map_to_geodetic(map_pts, georef):
    enu = map_to_enu(map_pts, georef)
    return enu_to_geodetic(
        enu, georef.latitude, georef.longitude, georef.height
    )
