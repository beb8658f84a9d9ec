"""Padded structure-of-arrays point clouds.

Port of ``mp2p_icp_tpu/core/pointcloud.py``. The layout is kept as it is: a
fixed-capacity ``[C, 3]`` tensor plus a validity ``count``, with padding rows
at the ``PAD_VALUE`` sentinel and capacities rounded by ``round_capacity``.
Row-for-row parity with the JAX package follows from that, and fixed shapes
keep CUDA-graph capture possible later.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.device import resolve


def round_capacity(n: int, minimum: int = 256) -> int:
    """Round n up to the next power of two (>= minimum)."""
    c = max(int(minimum), 1)
    while c < n:
        c *= 2
    return c


def scatter_rows(target: torch.Tensor, dest: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """A copy of ``target`` [..., C(, w)] with the rows of ``src``
    [..., N(, w)] written at ``dest`` [..., N]; leading axes are independent
    problems. Rows that must not land are sent to row C: an extra row takes
    them and is cut off, so no two kept rows ever share a destination."""
    axis = dest.ndim - 1
    C = target.shape[axis]
    extra = target.new_zeros(target.shape[:axis] + (1,) + target.shape[axis + 1:])
    index = dest.reshape(dest.shape + (1,) * (src.ndim - dest.ndim)).expand(src.shape)
    return torch.cat([target, extra], dim=axis).scatter_(axis, index, src).narrow(axis, 0, C)


def take_rows(source: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``source`` [..., C(, w)] at the rows ``rows`` [..., M] (int64) of each
    problem: [..., M(, w)]. Without leading axes it is ``source[rows]``."""
    if source.ndim == rows.ndim:
        return torch.gather(source, -1, rows)
    return torch.gather(source, -2, rows[..., None].expand(*rows.shape, source.shape[-1]))


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Fixed-capacity SoA point cloud.

    xyz:    [C, 3] float32; rows >= count are padding at PAD_VALUE.
    count:  scalar int32 tensor on the cloud's device — number of valid
            leading rows.
    intensity / ring / time: optional [C] channels; normals: optional [C, 3].

    A batch of clouds (``parallel.batch``) carries a leading axis on every
    field: xyz [B, C, 3], count [B]. The class is a pytree node (its
    tensors are the leaves), so ``torch.func.vmap`` maps over it.
    """

    xyz: torch.Tensor
    count: torch.Tensor
    intensity: Optional[torch.Tensor] = None
    ring: Optional[torch.Tensor] = None
    time: Optional[torch.Tensor] = None
    normals: Optional[torch.Tensor] = None

    PAD_VALUE = 1.0e8  # sentinel coordinate for padding rows

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def valid_mask(self) -> torch.Tensor:
        """[..., C] bool: the leading ``count`` rows of each cloud."""
        return torch.arange(self.capacity, device=self.device) < self.count[..., None]

    @staticmethod
    def from_numpy(
        xyz: np.ndarray,
        capacity: Optional[int] = None,
        intensity: Optional[np.ndarray] = None,
        ring: Optional[np.ndarray] = None,
        time: Optional[np.ndarray] = None,
        device=None,
    ) -> "PointCloud":
        device = resolve(device)
        xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
        n = xyz.shape[0]
        cap = capacity or round_capacity(n)
        if cap < n:
            raise ValueError(f"capacity {cap} < point count {n}")
        buf = np.full((cap, 3), PointCloud.PAD_VALUE, dtype=np.float32)
        buf[:n] = xyz

        def pad_channel(ch):
            if ch is None:
                return None
            ch = np.asarray(ch, dtype=np.float32).reshape(-1)
            if ch.shape[0] != n:
                raise ValueError("channel length mismatch")
            out = np.zeros((cap,), dtype=np.float32)
            out[:n] = ch
            return torch.from_numpy(out).to(device)

        return PointCloud(
            xyz=torch.from_numpy(buf).to(device),
            count=torch.tensor(n, dtype=torch.int32, device=device),
            intensity=pad_channel(intensity),
            ring=pad_channel(ring),
            time=pad_channel(time),
        )

    @staticmethod
    def empty(capacity: int, device=None) -> "PointCloud":
        device = resolve(device)
        return PointCloud(
            xyz=torch.full((capacity, 3), PointCloud.PAD_VALUE, dtype=torch.float32,
                           device=device),
            count=torch.tensor(0, dtype=torch.int32, device=device),
        )

    def to_numpy(self) -> np.ndarray:
        return self.xyz[: int(self.count)].cpu().numpy()

    def bounding_box(self):
        """(min, max) over the valid points; (+inf, -inf) if there are none."""
        m = self.valid_mask()[..., None]
        mn = torch.where(m, self.xyz, torch.inf).amin(dim=-2)
        mx = torch.where(m, self.xyz, -torch.inf).amax(dim=-2)
        return mn, mx

    def transformed(self, pose) -> "PointCloud":
        """Rigidly transform valid points (padding rows stay at the
        sentinel); normals rotate with the pose. A batch of clouds takes a
        batch of poses."""
        from mp2p_icp_tpu_torch.core import se3

        m = self.valid_mask()[..., None]
        new_xyz = torch.where(m, se3.apply(pose, self.xyz), self.xyz)
        nrm = self.normals
        if nrm is not None:
            nrm = torch.where(m, se3.rotate(pose, nrm), nrm)
        return dataclasses.replace(self, xyz=new_xyz, normals=nrm)

    def with_points(self, xyz: torch.Tensor, count: torch.Tensor) -> "PointCloud":
        return dataclasses.replace(self, xyz=xyz, count=count)


def sanity_check(pc: PointCloud) -> bool:
    """Channel-length validation (reference: pointcloud_sanity_check.cpp:27-76):
    with fixed capacities, every channel spans the capacity and the count
    fits in it."""
    for ch in (pc.intensity, pc.ring, pc.time, pc.normals):
        if ch is not None and ch.shape[0] != pc.capacity:
            return False
    return int(pc.count) <= pc.capacity


_FIELDS = tuple(f.name for f in dataclasses.fields(PointCloud))


def _flatten(pc: PointCloud):
    names = tuple(n for n in _FIELDS if getattr(pc, n) is not None)
    return [getattr(pc, n) for n in names], names


pytree.register_pytree_node(
    PointCloud, _flatten, lambda leaves, names: PointCloud(**dict(zip(names, leaves))),
    serialized_type_name="mp2p_icp_tpu_torch.PointCloud",
)
