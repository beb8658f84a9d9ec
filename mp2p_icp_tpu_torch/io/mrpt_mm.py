"""Reader and writer of the reference's binary MRPT ``.mm`` archives.

Port of ``mp2p_icp_tpu/io/mrpt_mm.py`` (reference: metricmap.cpp:48-178
serializeTo / serializeFrom, :651-677 save / load_to_file): a gzipped MRPT
CSerializable archive of one ``mp2p_icp::metric_map_t`` (versions 0-5):

    object  := (len|0x80):u8  class_name  version:u8  payload  0x88
    string  := len:u32le bytes
    payload := vector<TLine3D> framing ("std::vector","TLine3D",n,48B each)
               planes:u32 (TPlane 4xf64 + centroid 3xf64 each)
               lines:u32  (48B each)
               layers:u32 { name:string, object }
               v>=1: id:optional<uint64>, label:optional<string>
                     (typed framing: "std::optional", typename, bool, value)
               v2-3: inline georef; v>=4: delegated georef
                     (magic "mp2p_icp::Georeferencing", metricmap.cpp:824-870)
               v>=5: metadata bool + YAML string

Point layers: ``mrpt::maps::CSimplePointsMap`` v10 (n, x[n], y[n], z[n]
f32, the TMapGenericParams sub-object, a 62-byte options blob),
``CPointsMapXYZI`` v0 (what kitti2mm writes, kitti2mm/main.cpp:59-68: n,
x/y/z/intensity, generic params, a fixed options tail found by a
structurally checked end-marker scan) and ``CPointsMapXYZIRT`` v0 (n, x/y/z,
length-prefixed intensity f32 / ring u16 / time f32 vectors, generic
params, options tail).

Georeferencing (metricmap.cpp:824-870): lat/lon/height f64 and
``T_enu_to_map`` as an ``mrpt::poses::CPose3DPDFGaussian``: the CPose3D mean
(v2: x y z qr qx qy qz f64) and the 6x6 covariance (6 diagonal then 15
upper-triangle f64; a size-prefixed and a full-36 variant are accepted, each
checked against the object's end marker).

A layer of an unknown class (e.g. the Bonxai ``CVoxelMap`` that the
reference's voxel-map pipelines write) is skipped with a warning through a
structural resync (``strict=True`` raises). The sparse voxel layers of this
package round-trip under the class name ``mp2p_icp_tpu::VoxelGridLayer``
inside the same framing. The byte layout is the JAX package's: the writer's
output is byte for byte the JAX writer's for the same map (the gzip header
names the file, so compare files of the same name). numpy and ``struct`` on
the host; the layers' tensors go to and come from ``device``.
"""

from __future__ import annotations

import gzip
import struct
import warnings
from typing import Optional

import numpy as np
import torch

from mp2p_icp_tpu_torch.core.metric_map import (
    Georeferencing,
    LineSet,
    MetricMap,
    PlaneSet,
    VoxelGridLayer,
)
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.device import resolve
from mp2p_icp_tpu_torch.io.mm import to_numpy

_END = 0x88


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.i = 0

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.d):
            raise ValueError(
                f".mm parse error: need {n} bytes at offset {self.i}, "
                f"file has {len(self.d)}"
            )
        out = self.d[self.i : self.i + n]
        self.i += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def f32s(self, n: int) -> np.ndarray:
        return np.frombuffer(self.take(4 * n), dtype="<f4").copy()

    def f64s(self, n: int) -> np.ndarray:
        return np.frombuffer(self.take(8 * n), dtype="<f8").copy()

    def u16s(self, n: int) -> np.ndarray:
        return np.frombuffer(self.take(2 * n), dtype="<u2").copy()

    def i32s(self, n: int) -> np.ndarray:
        return np.frombuffer(self.take(4 * n), dtype="<i4").copy()

    def boolean(self) -> bool:
        return self.u8() != 0

    def string(self) -> str:
        n = self.u32()
        if n > 1 << 20:
            raise ValueError(f".mm parse error: absurd string length {n}")
        return self.take(n).decode("latin-1")

    def object_header(self):
        """-> (class_name, version). MRPT writes len(name)|0x80 as one byte
        (two-byte extension for names >127 chars never occurs here)."""
        b = self.u8()
        if not (b & 0x80):
            raise ValueError(
                f".mm parse error: expected object header at {self.i - 1}, "
                f"got byte 0x{b:02x}"
            )
        name = self.take(b & 0x7F).decode("latin-1")
        version = self.u8()
        return name, version

    def expect_end(self, what: str):
        b = self.u8()
        if b != _END:
            raise ValueError(
                f".mm parse error: missing end marker after {what} at "
                f"offset {self.i - 1} (got 0x{b:02x})"
            )

    def typed_optional(self):
        """std::optional<T> framing: container name, type name, bool, value.
        Returns (typename, present)."""
        cont = self.string()
        if cont != "std::optional":
            raise ValueError(
                f".mm parse error: expected std::optional, got '{cont}'"
            )
        tname = self.string()
        return tname, self.boolean()


class _Writer:
    def __init__(self):
        self.b = bytearray()

    def u8(self, v: int):
        self.b.append(v & 0xFF)

    def u32(self, v: int):
        self.b += struct.pack("<I", v)

    def u64(self, v: int):
        self.b += struct.pack("<Q", v)

    def f64(self, v: float):
        self.b += struct.pack("<d", float(v))

    def f32_array(self, a: np.ndarray):
        self.b += np.ascontiguousarray(a, dtype="<f4").tobytes()

    def f64_array(self, a: np.ndarray):
        self.b += np.ascontiguousarray(a, dtype="<f8").tobytes()

    def u16_array(self, a: np.ndarray):
        self.b += np.ascontiguousarray(a, dtype="<u2").tobytes()

    def i32_array(self, a: np.ndarray):
        self.b += np.ascontiguousarray(a, dtype="<i4").tobytes()

    def string(self, s: str):
        raw = s.encode("latin-1")
        self.u32(len(raw))
        self.b += raw

    def obj_header(self, name: str, version: int):
        raw = name.encode("latin-1")
        if len(raw) > 127:
            raise ValueError(f"class name too long: {name}")
        self.u8(0x80 | len(raw))
        self.b += raw
        self.u8(version)

    def end(self):
        self.u8(_END)

    def boolean(self, v: bool):
        self.u8(1 if v else 0)


# ------------------------------------------------------------ options blobs
# The fixed-size MRPT map-options tail as serialized by the reference's own
# demo data (default-constructed options; boundaries verified field by
# field): insertionOptions (19 B: version + minDistBetweenLaserPoints f32 +
# 5 bools + horizontalTolerance f32 + maxDistForInterpolatePoints f32 +
# insertInvalidPoints bool), likelihoodOptions (21 B: version + sigma_dist
# f64 + max_corr_distance f64 + decimation u32), renderOptions (22 B:
# version + point_size f32 + TColorf RGBA 4xf32 + colormap i8).
_OPTS_INSERTION = bytes.fromhex("000ad7a33c010001000088c3643a0000004000")
_OPTS_LIKELIHOOD = bytes.fromhex("007b14ae47e17a643f000000000000f03f0a000000")
_OPTS_RENDER = bytes.fromhex("000000803f00000000000000000000803f0000803fff")
_SIMPLEPOINTS_V10_OPTS = _OPTS_INSERTION + _OPTS_LIKELIHOOD + _OPTS_RENDER
assert len(_SIMPLEPOINTS_V10_OPTS) == 62
# CPointsMapXYZI/XYZIRT v0 write insertion + likelihood options only
_XYZI_V0_OPTS = _OPTS_INSERTION + _OPTS_LIKELIHOOD

_GENERIC_PARAMS_CLS = "mrpt::maps::TMapGenericParams"


def _parse_generic_params(r: _Reader):
    name, _ = r.object_header()
    if name != _GENERIC_PARAMS_CLS:
        raise ValueError(
            f".mm: expected TMapGenericParams sub-object, got '{name}'"
        )
    bools = r.take(3)
    r.expect_end("TMapGenericParams")
    return bools


def _consume_options_tail(r: _Reader, what: str, continuation_ok, max_tail=256):
    """Locate the layer object's end marker past a fixed-size (version-
    dependent) MRPT options tail whose exact length we do not hard-code:
    scan forward for 0x88 whose CONTINUATION parses as the enclosing
    structure expects (next layer-name string / std::optional framing /
    archive end). Returns the tail length consumed."""
    start = r.i
    limit = min(start + max_tail, len(r.d))
    for j in range(start, limit):
        if r.d[j] == _END and continuation_ok(j + 1):
            r.i = j + 1
            return j - start
    raise ValueError(
        f".mm: could not locate the end of the {what} options tail within "
        f"{max_tail} bytes at offset {start} — unsupported serialization "
        "layout"
    )


def _parse_simple_points_map(r: _Reader, version: int):
    if version != 10:
        raise ValueError(
            f".mm: CSimplePointsMap serialization v{version} unsupported "
            "(only v10, the current reference format)"
        )
    n = r.u32()
    x = r.f32s(n)
    y = r.f32s(n)
    z = r.f32s(n)
    _parse_generic_params(r)
    r.take(len(_SIMPLEPOINTS_V10_OPTS))
    r.expect_end("CSimplePointsMap")
    return np.stack([x, y, z], axis=1).astype(np.float32), {}


def _parse_points_map_xyzi(r: _Reader, version: int, continuation_ok):
    """mrpt::maps::CPointsMapXYZI v0 (the class apps/kitti2mm emits,
    kitti2mm/main.cpp:59-68): n, x/y/z/intensity f32 arrays, generic
    params, fixed options tail."""
    if version != 0:
        raise ValueError(
            f".mm: CPointsMapXYZI serialization v{version} unsupported"
        )
    n = r.u32()
    x = r.f32s(n)
    y = r.f32s(n)
    z = r.f32s(n)
    inten = r.f32s(n)
    _parse_generic_params(r)
    _consume_options_tail(r, "CPointsMapXYZI", continuation_ok)
    return (
        np.stack([x, y, z], axis=1).astype(np.float32),
        {"intensity": inten},
    )


def _parse_points_map_xyzirt(r: _Reader, version: int, continuation_ok):
    """mrpt::maps::CPointsMapXYZIRT v0: n + x/y/z arrays, then
    length-prefixed intensity (f32) / ring (u16) / time (f32) channel
    vectors (each empty or length n), generic params, options tail."""
    if version != 0:
        raise ValueError(
            f".mm: CPointsMapXYZIRT serialization v{version} unsupported"
        )
    n = r.u32()
    x = r.f32s(n)
    y = r.f32s(n)
    z = r.f32s(n)

    def channel(reader_fn, name):
        m = r.u32()
        if m not in (0, n):
            raise ValueError(
                f".mm: XYZIRT {name} channel length {m} != point count {n}"
            )
        return reader_fn(m) if m else None

    inten = channel(r.f32s, "intensity")
    ring = channel(r.u16s, "ring")
    time = channel(r.f32s, "time")
    _parse_generic_params(r)
    _consume_options_tail(r, "CPointsMapXYZIRT", continuation_ok)
    ch = {}
    if inten is not None:
        ch["intensity"] = inten
    if ring is not None:
        ch["ring"] = ring.astype(np.float32)
    if time is not None:
        ch["time"] = time
    return np.stack([x, y, z], axis=1).astype(np.float32), ch


_POINT_LAYER_PARSERS = {
    "CSimplePointsMap": lambda r, v, cont: _parse_simple_points_map(r, v),
    "CPointsMapXYZI": _parse_points_map_xyzi,
    "CPointsMapXYZIRT": _parse_points_map_xyzirt,
}


def _parse_lines_vector(r: _Reader):
    cont = r.string()
    if cont != "std::vector":
        raise ValueError(f".mm: expected std::vector framing, got '{cont}'")
    tname = r.string()
    if tname != "TLine3D":
        raise ValueError(f".mm: expected TLine3D vector, got '{tname}'")
    n = r.u32()
    return r.f64s(6 * n).reshape(n, 6) if n else np.zeros((0, 6))


def _sym_cov_from_parts(diag: np.ndarray, upper: np.ndarray) -> np.ndarray:
    m = np.diag(diag).astype(np.float64)
    k = 0
    for r_ in range(5):
        for c in range(r_ + 1, 6):
            m[r_, c] = m[c, r_] = upper[k]
            k += 1
    return m


def _cov_sane(diag: np.ndarray) -> bool:
    return bool(np.all(np.isfinite(diag)) and np.all(diag >= 0) and np.all(diag < 1e15))


def _parse_cov66(r: _Reader) -> np.ndarray:
    """6x6 covariance payload of CPose3DPDFGaussian. MRPT's symmetric-matrix
    serialization stores 6 diagonal + 15 upper-triangle f64; accept also a
    u32(6)-size-prefixed variant and a full 36-f64 dump. Each candidate is
    only trusted if the object end marker lands exactly after it AND the
    diagonal is a plausible variance vector; otherwise roll back."""
    save = r.i

    def at_end_marker() -> bool:
        # bounds-checked peek: a truncated buffer must fall through to the
        # next layout candidate / the descriptive error, not IndexError
        return r.i < len(r.d) and r.d[r.i] == _END

    # (a) symmetric, no size prefix: 21 f64
    try:
        vals = r.f64s(21)
        if at_end_marker() and _cov_sane(vals[:6]):
            return _sym_cov_from_parts(vals[:6], vals[6:])
    except ValueError:
        pass
    r.i = save
    # (b) u32 size prefix
    try:
        if r.u32() == 6:
            vals = r.f64s(21)
            if at_end_marker() and _cov_sane(vals[:6]):
                return _sym_cov_from_parts(vals[:6], vals[6:])
    except ValueError:
        pass
    r.i = save
    # (c) full row-major 36 f64
    try:
        vals = r.f64s(36)
        m = vals.reshape(6, 6)
        if (
            at_end_marker()
            and _cov_sane(np.diag(m))
            and np.allclose(m, m.T, rtol=0, atol=1e-9)
        ):
            return m
    except ValueError:
        pass
    raise ValueError(
        ".mm: unrecognized CPose3DPDFGaussian covariance layout at offset "
        f"{save}"
    )


def _parse_georeferencing(r: _Reader):
    """metricmap.cpp:827-850 operator>>: magic string, u8 version, bool
    present, then lat/lon/height f64 + T_enu_to_map CPose3DPDFGaussian."""
    magic = r.string()
    if magic != "mp2p_icp::Georeferencing":
        raise ValueError(f".mm: bad georef magic '{magic}'")
    ver = r.u8()
    if ver != 0:
        raise ValueError(f".mm: georef serialization v{ver} unsupported")
    if not r.boolean():
        return None
    lat, lon, height = r.f64s(1)[0], r.f64s(1)[0], r.f64s(1)[0]
    cls, _pver = r.object_header()
    if cls != "mrpt::poses::CPose3DPDFGaussian":
        raise ValueError(
            f".mm: T_enu_to_map is '{cls}', expected CPose3DPDFGaussian"
        )
    mcls, mver = r.object_header()
    if mcls != "mrpt::poses::CPose3D":
        raise ValueError(f".mm: pose mean is '{mcls}', expected CPose3D")
    if mver != 2:
        raise ValueError(
            f".mm: CPose3D serialization v{mver} unsupported (v2 = "
            "x y z qr qx qy qz as f64)"
        )
    vals = r.f64s(7)
    r.expect_end("CPose3D")
    x, y, z, qr, qx, qy, qz = vals
    qn = qr * qr + qx * qx + qy * qy + qz * qz
    if abs(qn - 1.0) > 1e-6:
        raise ValueError(
            f".mm: CPose3D quaternion norm {qn:.6f} != 1 — layout mismatch"
        )
    cov = _parse_cov66(r)
    r.expect_end("CPose3DPDFGaussian")
    return Georeferencing(
        latitude=float(lat),
        longitude=float(lon),
        height=float(height),
        t_enu_to_map_xyz=(float(x), float(y), float(z)),
        t_enu_to_map_quat_wxyz=(float(qr), float(qx), float(qy), float(qz)),
        t_enu_to_map_cov=tuple(tuple(float(v) for v in row) for row in cov),
    )


_VOXEL_LAYER_CLASS = "mp2p_icp_tpu::VoxelGridLayer"


def _parse_voxel_grid_layer(r: _Reader, version: int, device):
    """The package's sparse voxel layer encoding (see save_mrpt_mm)."""
    if version != 0:
        raise ValueError(
            f".mm: {_VOXEL_LAYER_CLASS} v{version} unsupported (have v0)"
        )
    resolution = float(r.f64s(1)[0])
    n = r.u32()
    keys = r.i32s(3 * n).reshape(n, 3)
    occ = r.f32s(n)
    r.expect_end(_VOXEL_LAYER_CLASS)
    cap = max(1, n)
    pad = cap - n
    return VoxelGridLayer(
        keys=_tensor(np.concatenate([keys, np.zeros((pad, 3), np.int32)]), device),
        occupancy=_tensor(np.concatenate([occ, np.full((pad,), 0.5, np.float32)]), device),
        valid=_tensor(np.concatenate([np.ones((n,), bool), np.zeros((pad,), bool)]), device),
        resolution=resolution,
    )


def _skip_unknown_layer(r: _Reader, continuation_ok) -> int:
    """Resync past an unknown layer class: advance to the first 0x88 end
    marker whose successor position satisfies the structural continuation
    check (next layer's name+header, the post-layers optional framing, or
    archive end). Returns the number of payload bytes skipped.

    This is the fail-soft path for layer classes whose byte layout is not
    known here (e.g. the Bonxai CVoxelMap of the reference's
    sm2mm_bonxai_voxelmap.yaml pipelines, serialized by
    metricmap.cpp:89-178 for any CMetricMap subclass): a blind decoder
    could not be checked, but the rest of the archive still parses, so
    the object is skipped instead of raising."""
    start = r.i
    d = np.frombuffer(r.d, dtype=np.uint8)
    candidates = np.flatnonzero(d[start:] == _END)
    for off in candidates:
        pos = start + int(off)
        if continuation_ok(pos + 1):
            r.i = pos + 1
            return pos - start
    raise ValueError(
        ".mm: could not resync past unknown layer payload starting at "
        f"offset {start}"
    )


def load_mrpt_mm(path: str, strict: bool = False, device=None):
    """Load a reference binary ``.mm`` file -> MetricMap with PointCloud
    layers on ``device`` (default: the package's default device), and
    .id / .label / .georeferencing when present; the raw lines and planes
    ride as ``lines_raw`` / ``planes_raw`` [n, 6] / [n, 7] float64.

    Unknown layer classes (e.g. the reference's Bonxai CVoxelMap /
    COccupancyGridMap3D blocks, whose byte layouts are not known here)
    are skipped with a warning when the rest of the archive parses;
    ``strict=True`` raises instead."""
    device = resolve(device)
    with open(path, "rb") as f:
        head = f.read(2)
    raw = (
        gzip.open(path, "rb").read()
        if head == b"\x1f\x8b"
        else open(path, "rb").read()
    )
    r = _Reader(raw)
    name, version = r.object_header()
    if name != "mp2p_icp::metric_map_t":
        raise ValueError(f".mm: top-level object is '{name}', not metric_map_t")
    if version > 5:
        raise ValueError(f".mm: metric_map_t v{version} unsupported (max 5)")

    _parse_lines_vector(r)  # serialized 'lines' (legacy duplicate write)
    n_planes = r.u32()
    planes = r.f64s(7 * n_planes).reshape(n_planes, 7) if n_planes else None
    n_lines = r.u32()
    lines = r.f64s(6 * n_lines).reshape(n_lines, 6) if n_lines else None

    layers = {}
    n_layers = r.u32()

    def make_continuation_ok(layers_remaining: int):
        """True iff parsing may resume at `pos`: the next layer's name
        string + object header, or the post-layers optional framing
        (v>=1), or the archive end (v0)."""

        def ok(pos: int) -> bool:
            rr = _Reader(r.d)
            rr.i = pos
            try:
                if layers_remaining > 0:
                    lname = rr.string()
                    if not (0 < len(lname) <= 128):
                        return False
                    return bool(rr.u8() & 0x80)
                if version >= 1:
                    return rr.string() == "std::optional"
                return rr.u8() == _END
            except ValueError:
                return False

        return ok

    for li in range(n_layers):
        lname = r.string()
        cls, cver = r.object_header()
        cont_ok = make_continuation_ok(n_layers - li - 1)
        if cls == _VOXEL_LAYER_CLASS:
            layers[lname] = _parse_voxel_grid_layer(r, cver, device)
            continue
        short = cls.split("::")[-1]
        parser = _POINT_LAYER_PARSERS.get(short)
        if parser is None:
            if strict:
                raise ValueError(
                    f".mm: layer '{lname}' has unsupported class '{cls}' — "
                    "the parser handles CSimplePointsMap / CPointsMapXYZI / "
                    "CPointsMapXYZIRT point layers"
                )
            skipped = _skip_unknown_layer(r, cont_ok)
            warnings.warn(
                f".mm: skipping layer '{lname}' of unsupported class "
                f"'{cls}' ({skipped} payload bytes) — its byte layout is "
                "outside the verifiable format surface (pass strict=True "
                "to raise instead)",
                stacklevel=2,
            )
            continue
        xyz, channels = parser(r, cver, cont_ok)
        layers[lname] = PointCloud.from_numpy(xyz, device=device, **channels)

    mm = MetricMap(layers=layers, lines=LineSet.empty(device=device),
                   planes=PlaneSet.empty(device=device))
    if version >= 1:
        tname, present = r.typed_optional()
        if present:
            mm.id = r.u64()
        tname, present = r.typed_optional()
        if present:
            mm.label = r.string()
    if 2 <= version < 4:
        if r.boolean():
            raise ValueError(".mm: inline georef (v2/3) unsupported")
    if version >= 4:
        mm.georeferencing = _parse_georeferencing(r)
    if version >= 5:
        if r.boolean():
            r.string()  # metadata YAML text (kept unparsed)
    r.expect_end("metric_map_t")

    if lines is not None and len(lines):
        mm.lines_raw = lines
    if planes is not None and len(planes):
        mm.planes_raw = planes
    return mm


# ------------------------------------------------------------------- writer
def _write_point_layer(w: _Writer, pc) -> None:
    """Serialize one PointCloud layer in the reference's own class/byte
    layout: CSimplePointsMap v10 for plain xyz clouds, CPointsMapXYZI v0
    when an intensity channel is present, CPointsMapXYZIRT v0 when
    ring/time channels exist (the classes kitti2mm and LiDAR pipelines
    produce, kitti2mm/main.cpp:59-68)."""
    n = int(pc.count)
    xyz = to_numpy(pc.xyz[:n]).astype(np.float32)

    def ch(name):
        a = getattr(pc, name)
        return None if a is None else to_numpy(a[:n]).astype(np.float32)

    inten, ring, time = ch("intensity"), ch("ring"), ch("time")
    has_rt = ring is not None or time is not None

    def write_generic_params():
        w.obj_header(_GENERIC_PARAMS_CLS, 0)
        w.b += b"\x01\x01\x01"
        w.end()

    if has_rt:
        w.obj_header("mrpt::maps::CPointsMapXYZIRT", 0)
        w.u32(n)
        for c in range(3):
            w.f32_array(xyz[:, c])
        for vec, conv in (
            (inten, w.f32_array),
            (
                None if ring is None else ring.astype(np.uint16),
                w.u16_array,
            ),
            (time, w.f32_array),
        ):
            if vec is None:
                w.u32(0)
            else:
                w.u32(n)
                conv(vec)
        write_generic_params()
        w.b += _XYZI_V0_OPTS
        w.end()
    elif inten is not None:
        w.obj_header("mrpt::maps::CPointsMapXYZI", 0)
        w.u32(n)
        for c in range(3):
            w.f32_array(xyz[:, c])
        w.f32_array(inten)
        write_generic_params()
        w.b += _XYZI_V0_OPTS
        w.end()
    else:
        w.obj_header("mrpt::maps::CSimplePointsMap", 10)
        w.u32(n)
        for c in range(3):
            w.f32_array(xyz[:, c])
        write_generic_params()
        w.b += _SIMPLEPOINTS_V10_OPTS
        w.end()


def _write_georeferencing(w: _Writer, g) -> None:
    w.string("mp2p_icp::Georeferencing")
    w.u8(0)
    w.boolean(g is not None)
    if g is None:
        return
    w.f64(g.latitude)
    w.f64(g.longitude)
    w.f64(g.height)
    w.obj_header("mrpt::poses::CPose3DPDFGaussian", 1)
    w.obj_header("mrpt::poses::CPose3D", 2)
    for v in g.t_enu_to_map_xyz:
        w.f64(v)
    for v in g.t_enu_to_map_quat_wxyz:
        w.f64(v)
    w.end()
    cov = (
        np.zeros((6, 6))
        if g.t_enu_to_map_cov is None
        else np.asarray(g.t_enu_to_map_cov, dtype=np.float64)
    )
    w.f64_array(np.diag(cov))
    upper = [cov[r_, c] for r_ in range(5) for c in range(r_ + 1, 6)]
    w.f64_array(np.asarray(upper))
    w.end()


def save_mrpt_mm(mm, path: str, version: Optional[int] = None,
                 gzipped: bool = True) -> None:
    """Write a MetricMap as a reference-compatible binary ``.mm`` archive
    (metricmap.cpp:48-105 serializeTo + :651-661 save_to_file gzip
    container). ``version``: metric_map_t serialization version to emit —
    default 1 when the map carries no georeferencing (the version the
    reference demos were written with), else 5. Sparse voxel layers are
    written in the package's own encoding under the class name
    ``mp2p_icp_tpu::VoxelGridLayer`` (read back by load_mrpt_mm; see the
    module docstring); other layer types raise."""
    if version is None:
        version = 1 if mm.georeferencing is None else 5
    if version not in (1, 5):
        raise ValueError(f"save_mrpt_mm: unsupported emit version {version}")
    if mm.georeferencing is not None and version < 4:
        raise ValueError(
            "save_mrpt_mm: map carries georeferencing but the v"
            f"{version} layout predates the georef block (v4+) — emitting "
            "it would silently drop lat/lon/height and T_enu_to_map; pass "
            "version=5 (or version=None)"
        )

    w = _Writer()
    w.obj_header("mp2p_icp::metric_map_t", version)
    # legacy duplicate 'lines' vector with typed framing
    lines = getattr(mm, "lines_raw", None)
    n_lines = 0 if lines is None else len(lines)
    w.string("std::vector")
    w.string("TLine3D")
    w.u32(n_lines)
    if n_lines:
        w.f64_array(np.asarray(lines, dtype=np.float64).reshape(-1))
    planes = getattr(mm, "planes_raw", None)
    n_planes = 0 if planes is None else len(planes)
    w.u32(n_planes)
    if n_planes:
        w.f64_array(np.asarray(planes, dtype=np.float64).reshape(-1))
    w.u32(n_lines)
    if n_lines:
        w.f64_array(np.asarray(lines, dtype=np.float64).reshape(-1))

    writable = {
        k: v
        for k, v in mm.layers.items()
        if isinstance(v, (PointCloud, VoxelGridLayer))
    }
    if len(writable) != len(mm.layers):
        bad = [k for k in mm.layers if k not in writable]
        raise ValueError(
            f"save_mrpt_mm: layers {bad} have no binary .mm encoding "
            "(point and sparse-voxel layers only — save as .mm.npz "
            "instead)"
        )
    w.u32(len(writable))
    for lname, layer in writable.items():
        w.string(lname)
        if isinstance(layer, PointCloud):
            _write_point_layer(w, layer)
        else:
            # the package's sparse voxel encoding inside the reference's
            # container framing (the reference serializes any CMetricMap
            # subclass, metricmap.cpp:89-178): read back by load_mrpt_mm,
            # skipped by the fail-soft path of any other reader
            w.obj_header(_VOXEL_LAYER_CLASS, 0)
            valid = to_numpy(layer.valid)
            keys = to_numpy(layer.keys)[valid]
            occ = to_numpy(layer.occupancy)[valid]
            w.f64(float(layer.resolution))
            w.u32(int(valid.sum()))
            w.i32_array(keys.reshape(-1))
            w.f32_array(occ)
            w.end()

    # id / label optionals
    w.string("std::optional")
    w.string("uint64_t")
    w.boolean(mm.id is not None)
    if mm.id is not None:
        w.u64(int(mm.id))
    w.string("std::optional")
    w.string("std::string")
    w.boolean(mm.label is not None)
    if mm.label is not None:
        w.string(mm.label)

    if version >= 4:
        _write_georeferencing(w, mm.georeferencing)
    if version >= 5:
        w.boolean(False)  # no metadata YAML
    w.end()

    payload = bytes(w.b)
    if gzipped:
        with open(path, "wb") as f:
            # mtime=0 for deterministic output
            with gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as gz:
                gz.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)
