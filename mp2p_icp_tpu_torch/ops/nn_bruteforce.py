"""Exact brute-force k-nearest-neighbour search.

Port of the local path of ``mp2p_icp_tpu/ops/nn_bruteforce.py``
(``knn_bruteforce``), with its contracts:

- invalid queries are moved to +1e8 and invalid points to -1e8 (sentinels
  of opposite sign, so two invalid entries never pair at distance ~0);
- ``dist_sq >= 0``; a pair is valid when its d² < 1e15, which covers query
  validity, point validity and padding with one test;
- an optional scalar or per-query ``max_radius_sq`` gate;
- invalid entries come back as idx -1 and dist_sq 3e37.

The sweep itself is ``knn_sweep``: on CUDA tensors it launches the Hopper
kernel ``csrc/knn_bruteforce.cu`` (which replaces the TPU kernel
``_nnk_kernel_gridless``), on CPU tensors it runs ``knn_plain``, the plain
PyTorch version of the same function.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from mp2p_icp_tpu_torch.ops import cuda_build

_BIG = 3.0e37
_FAR = 1.0e8
MAX_K = 8
# maps above this size need the streamed sweep (TPU kernel K3), not ported
STREAM_BLOCK = 131072
_PLAIN_CHUNK = 1024  # queries per step of knn_plain: bounds its [chunk, C, 3] temporary


class NNResult(NamedTuple):
    idx: torch.Tensor  # [Q, k] i32 (-1 invalid)
    dist_sq: torch.Tensor  # [Q, k] f32 (3e37 invalid)
    valid: torch.Tensor  # [Q, k] bool


def knn_plain(q: torch.Tensor, p: torch.Tensor, k: int):
    """Plain PyTorch kNN: explicit (q - p)² per pair, stable ascending sort,
    first k. The stable sort gives the lowest index on ties. Slots beyond
    the number of points stay (+inf, -1), as in the kernel.
    Returns (d2 [Q, k] f32, idx [Q, k] i32)."""
    Q, C = q.shape[0], p.shape[0]
    out_d = torch.full((Q, k), float("inf"), dtype=torch.float32, device=q.device)
    out_i = torch.full((Q, k), -1, dtype=torch.int32, device=q.device)
    kk = min(k, C)
    if kk == 0:
        return out_d, out_i
    for s in range(0, Q, _PLAIN_CHUNK):
        e = s + _PLAIN_CHUNK
        diff = q[s:e, None, :] - p[None, :, :]  # [chunk, C, 3]
        sq = diff * diff
        d = sq[..., 0] + sq[..., 1] + sq[..., 2]  # same rounding order as the kernel
        ds, order = torch.sort(d, dim=1, stable=True)
        out_d[s:e, :kk] = ds[:, :kk]
        out_i[s:e, :kk] = order[:, :kk].to(torch.int32)
    return out_d, out_i


@functools.lru_cache(maxsize=None)
def load_kernel():
    """Build (on first use) and load the kernel; returns its C entry point,
    configured once and cached."""
    lib = cuda_build.load_library("knn_bruteforce", ["knn_bruteforce.cu"])
    fn = lib.mp2p_knn_sweep_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def knn_sweep(q: torch.Tensor, p: torch.Tensor, k: int):
    """k nearest points of p [C, 3] for each query of q [Q, 3] (f32,
    contiguous, one device). Returns (d2 [Q, k] f32 ascending, idx [Q, k]
    i32), lowest index first on ties, (+inf, -1) in unfilled slots.

    CPU tensors run ``knn_plain``; CUDA tensors launch the Hopper kernel
    (and raise if it cannot be built or launched — there is no fallback).
    ``knn_sweep.launches`` counts kernel launches."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in 1..{MAX_K}, got {k}")
    for name, x in (("q", q), ("p", p)):
        if x.ndim != 2 or x.shape[1] != 3 or x.dtype != torch.float32:
            raise ValueError(f"{name} must be [N, 3] float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
    if q.device != p.device:
        raise ValueError(f"q on {q.device} but p on {p.device}")
    if q.device.type == "cpu":
        return knn_plain(q, p, k)
    if q.device.type != "cuda":
        raise NotImplementedError(f"knn_sweep has no kernel for {q.device}")
    if not (q.is_contiguous() and p.is_contiguous()):
        raise ValueError("knn_sweep needs contiguous q and p")
    Q, C = q.shape[0], p.shape[0]
    if Q >= 2**31 // 3 or C >= 2**31 // 3:
        raise ValueError("knn_sweep indexes with int32")
    out_d = torch.empty((Q, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=q.device)
    if Q == 0:
        return out_d, out_i
    fn = load_kernel()
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), Q, p.data_ptr(), C, k,
            out_d.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"knn_sweep kernel launch failed: CUDA error {err}")
    knn_sweep.launches += 1
    return out_d, out_i


knn_sweep.launches = 0


def knn_bruteforce(
    queries: torch.Tensor,
    query_valid: torch.Tensor,
    points: torch.Tensor,
    point_valid: torch.Tensor,
    k: int = 1,
    max_radius_sq=None,
    spatial_axis: Optional[str] = None,
    point_payload: Optional[torch.Tensor] = None,
) -> NNResult:
    """Exact kNN of queries [Q, 3] among points [C, 3].

    max_radius_sq: scalar or [Q] — pairs at or beyond it are invalidated.
    spatial_axis / point_payload (the spatially sharded map) and maps of
    more than STREAM_BLOCK points (the streamed sweep) are not ported yet.
    """
    if spatial_axis is not None or point_payload is not None:
        raise NotImplementedError(
            "knn_bruteforce: spatial_axis / point_payload (sharded maps) are "
            "not ported yet"
        )
    C = points.shape[0]
    if C > STREAM_BLOCK:
        raise NotImplementedError(
            f"knn_bruteforce: maps of more than {STREAM_BLOCK} points need the "
            "streamed sweep (TPU kernel _nnk_kernel_streamed_dbuf), not ported yet"
        )
    q = torch.where(query_valid[:, None], queries, _FAR).contiguous()
    p = torch.where(point_valid[:, None], points, -_FAR).contiguous()
    d2, idx = knn_sweep(q, p, k)
    valid = (idx >= 0) & (idx < C) & (d2 < 1.0e15)
    if max_radius_sq is not None:
        r = max_radius_sq  # a number, or a tensor on d2's device
        if isinstance(r, torch.Tensor) and r.ndim == 1:
            r = r[:, None]
        valid = valid & (d2 < r)
    return NNResult(
        idx=torch.where(valid, idx, -1),
        dist_sq=torch.where(valid, d2, _BIG),
        valid=valid,
    )
