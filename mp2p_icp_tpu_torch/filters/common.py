"""Shared helper of the mask filters.

Port of ``mp2p_icp_tpu/filters/common.py``: the kept rows of a cloud moved
to the front in input order under the same capacity. The JAX package
sorts the negated mask stably; here each kept row goes to its rank (a
cumulative sum) by one scatter, which gives the same rows in the same
order without a sort.
"""

from __future__ import annotations

import torch

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud, scatter_rows


def compact(pc: PointCloud, keep: torch.Tensor) -> PointCloud:
    """A new cloud of the valid rows of ``pc`` where ``keep`` holds, in
    input order; padding rows at the sentinel, channels zero there. As in
    the JAX package, the intensity, ring and time channels ride along and
    the normals do not."""
    keep = keep & pc.valid_mask()
    rank = torch.cumsum(keep, dim=-1) - 1
    dest = torch.where(keep, rank, pc.capacity)

    def ch(c):
        return None if c is None else scatter_rows(torch.zeros_like(c), dest, c)

    return PointCloud(
        xyz=scatter_rows(torch.full_like(pc.xyz, PointCloud.PAD_VALUE), dest, pc.xyz),
        count=torch.sum(keep, dim=-1, dtype=torch.int32),
        intensity=ch(pc.intensity), ring=ch(pc.ring), time=ch(pc.time),
    )


def variables_point(variables, names, default, device) -> torch.Tensor:
    """[3] float32 of the runtime variables ``names`` on ``device``, each
    ``default`` where absent (a variable is a number or a 0-d tensor)."""
    return torch.stack([
        torch.as_tensor(variables.get(n, d), dtype=torch.float32, device=device)
        for n, d in zip(names, default)
    ])
