"""Voxel-occupancy quality evaluator.

Port of ``mp2p_icp_tpu/quality/voxels.py`` (reference:
QualityEvaluator_Voxels.cpp:40-170): a symmetric two-pass comparison of the
local and global voxel grids. Each grid's cell centres are moved into the
other grid; every cell pair observed in both (|occ - 0.5| >= 0.01 on both
sides, :127) adds the reference's fitted agreement loss

    loss(x, y) = 1.5 + x + y - 12x² + 22xy - 12y²   (:43-57)

and quality = sigmoid(dist2quality_scale * mean loss), 0 without pairs
(:157-162). A missing or non-voxel layer raises, as the reference throws
(:66-91).

The cross-grid lookup is the JAX package's: cells sorted by a 31-bit
spatial hash of their integer keys, a binary search, and a probe of
``_PROBE`` sorted slots that compares the true keys, so a hash collision
never gives a false match.
"""

from __future__ import annotations

import dataclasses

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.metric_map import VoxelGridLayer
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.quality.paired_ratio import QualityResult

_PROBE = 8
_SENT = 2**31 - 1


def _loss(x, y):
    """Fitted quadratic agreement surface (QualityEvaluator_Voxels.cpp:55)."""
    return 1.5 + x + y - 12.0 * x * x + 22.0 * x * y - 12.0 * y * y


def _hash(keys: torch.Tensor) -> torch.Tensor:
    """[N, 3] int32 cell keys -> the JAX package's 31-bit Teschner codes
    (its int32 products wrap; the low 32 bits of int64 products are the
    same), kept below the invalid-row sentinel."""
    k = keys.to(torch.int64)
    h = (k[:, 0] * 73856093) ^ (k[:, 1] * 19349663) ^ (k[:, 2] * 83492791)
    return torch.clamp(h & 0x7FFFFFFF, max=_SENT - 1)


def lookup_occupancy(layer: VoxelGridLayer, qkeys: torch.Tensor, qvalid: torch.Tensor):
    """Occupancy of ``layer`` at the integer cells qkeys [L, 3]: (occ [L],
    found [L]); 0.5 where not found."""
    codes = torch.where(layer.valid, _hash(layer.keys), _SENT)
    scodes, order = torch.sort(codes, stable=True)
    skeys, socc, svalid = layer.keys[order], layer.occupancy[order], layer.valid[order]
    qc = _hash(qkeys)
    pos = torch.searchsorted(scodes, qc)
    C = scodes.shape[0]
    found = torch.zeros(qc.shape, dtype=torch.bool, device=qc.device)
    occ = torch.full(qc.shape, 0.5, device=qc.device)
    for off in range(_PROBE):
        p = torch.clamp(pos + off, 0, C - 1)
        hit = (scodes[p] == qc) & torch.all(skeys[p] == qkeys, dim=-1) & svalid[p] & ~found
        occ = torch.where(hit, socc[p], occ)
        found = found | hit
    return occ, found & qvalid


@dataclasses.dataclass(frozen=True)
class QualityVoxels:
    """Params (reference: QualityEvaluator_Voxels.h:40-45)."""

    voxel_layer_name: str = "voxelmap"
    dist2quality_scale: float = 2.0
    weight: float = 1.0
    # legacy aliases of the JAX package; voxel_layer_name is used when empty
    local_layer: str = ""
    global_layer: str = ""

    def _layer_names(self):
        return (self.local_layer or self.voxel_layer_name,
                self.global_layer or self.voxel_layer_name)

    def evaluate_voxels(self, local: VoxelGridLayer, globl: VoxelGridLayer,
                        pose: Pose) -> QualityResult:
        eps = 0.01

        def one_pass(src, dst, moved):
            keys = torch.floor(moved / dst.resolution).to(torch.int32)
            occ_dst, found = lookup_occupancy(dst, keys, src.valid)
            occ_src = src.occupancy
            counted = (found & (torch.abs(occ_src - 0.5) >= eps)
                       & (torch.abs(occ_dst - 0.5) >= eps))
            return (torch.sum(torch.where(counted, _loss(occ_src, occ_dst), 0.0)),
                    torch.sum(counted, dtype=torch.int32))

        # local cells into the global grid, then global cells into the local
        # grid (QualityEvaluator_Voxels.cpp:109-155 runs both directions)
        s1, n1 = one_pass(local, globl, se3.apply(pose, local.centers()))
        s2, n2 = one_pass(globl, local, se3.apply(se3.inverse(pose), globl.centers()))
        n = n1 + n2
        dist = torch.where(n > 0, (s1 + s2) / torch.clamp(n, min=1), 0.0)
        q = torch.where(n > 0, torch.sigmoid(self.dist2quality_scale * dist), 0.0)
        return QualityResult(quality=q, hard_discard=torch.zeros((), dtype=torch.bool,
                                                                 device=q.device))

    def evaluate(self, pairings, global_map=None, local_map=None, pose=None,
                 ctx=None) -> QualityResult:
        loc_name, glo_name = self._layer_names()
        for name, m, side in ((loc_name, local_map, "local"), (glo_name, global_map, "global")):
            if m is None or name not in m:
                raise ValueError(
                    f"QualityEvaluator_Voxels: {side} map has no layer '{name}' "
                    "(the reference throws here too, QualityEvaluator_Voxels.cpp:66-91)"
                )
            if not isinstance(m[name], VoxelGridLayer):
                raise ValueError(
                    f"QualityEvaluator_Voxels: {side} layer '{name}' must be a voxel grid")
        return self.evaluate_voxels(local_map[loc_name], global_map[glo_name], pose)
