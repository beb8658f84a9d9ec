"""ctypes bindings of the repo's host-side text parser.

The port's own copy of ``mp2p_icp_tpu/io/native.py``: ``native/fastload.cpp``
(built with ``make -C native``) parses whitespace- or comma-separated float
tables with a strtof loop. This is host code that feeds the device, not a
device kernel. Without the library (no compiler, a failed build) the numpy
path parses the same text to the same floats; the build is tried once.
"""

from __future__ import annotations

import ctypes
import io
import pathlib
import subprocess

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libfastload.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR), "libfastload.so"], check=True,
                           capture_output=True, timeout=60)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.parse_floats.restype = ctypes.c_int64
        lib.parse_floats.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
        lib.detect_columns.restype = ctypes.c_int32
        lib.detect_columns.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def parse_float_table(text: bytes, use_native: bool = True) -> np.ndarray:
    """A whitespace- or comma-separated float table (``#`` comments) as
    [N, cols] float32: the native parser where it is built, else (or with
    ``use_native=False``) numpy."""
    lib = _load() if use_native else None
    if lib is None:
        # the native loop takes commas for separators; np.loadtxt only
        # whitespace, so normalise first
        if b"," in text:
            text = text.replace(b",", b" ")
        return np.loadtxt(io.BytesIO(text), dtype=np.float32, ndmin=2)
    n_bytes = len(text)
    cols = lib.detect_columns(text, n_bytes)
    if cols <= 0:
        return np.zeros((0, 3), np.float32)
    max_vals = n_bytes // 2 + cols  # at most one value per 2 bytes
    out = np.empty(max_vals, np.float32)
    n = lib.parse_floats(text, n_bytes, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         max_vals)
    n_rows = n // cols
    return out[: n_rows * cols].reshape(n_rows, cols).copy()
