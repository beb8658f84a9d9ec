"""Sparse voxel occupancy map updates with free-space carving.

Port of ``mp2p_icp_tpu/ops/voxel_occupancy.py`` (the reference analogue:
Bonxai ``CVoxelMap`` insertion). Each sensor ray is sampled at
``ray_samples`` stratified points strictly inside the ray; the endpoint
voxel gets +l_hit and every sampled voxel +l_miss / (samples per voxel);
the existing records and the updates are merged by one sort of their cell
codes and a segment sum of log-odds, and the table is rebuilt from the
first ``capacity`` cells in code order.

Cell codes: the JAX package packs a cell into two sortable int32 keys
(``_pack``: k1 = (x + 2^14) * 2^15 + (y + 2^14), k2 = z + 2^14, each axis
clipped to [0, 2^15)). Here the same pair is one int64, k1 * 2^31 + k2,
which sorts in the same order, with the pair of int32 maxima as the
sentinel of invalid rows.
"""

from __future__ import annotations

import torch

from mp2p_icp_tpu_torch.core.metric_map import VoxelGridLayer

L_HIT = 1.2
L_MISS = -0.3
L_MIN, L_MAX = -6.0, 6.0
_OFF = 1 << 14
_I32_MAX = 2147483647
_KEY_SENT = _I32_MAX * (1 << 31) + _I32_MAX  # both int32 halves at their maximum


def _logodds(occ: torch.Tensor) -> torch.Tensor:
    occ = torch.clamp(occ, 1e-6, 1.0 - 1e-6)
    return torch.log(occ / (1.0 - occ))


def _cells(points: torch.Tensor, res: float) -> torch.Tensor:
    return torch.floor(points / res).to(torch.int32)


def _pack(cells: torch.Tensor) -> torch.Tensor:
    """[..., 3] int cell coords (±2^14 per axis, clipped) -> int64 codes."""
    c = torch.clamp(cells.to(torch.int64) + _OFF, 0, 2 * _OFF - 1)
    return (c[..., 0] * (1 << 15) + c[..., 1]) * (1 << 31) + c[..., 2]


def update_voxel_map(
    vg: VoxelGridLayer,
    points: torch.Tensor,
    point_valid: torch.Tensor,
    sensor_origin: torch.Tensor,
    ray_samples: int = 32,
    carve_free_space: bool = True,
) -> VoxelGridLayer:
    """Insert one scan into the voxel map. points: [N, 3] endpoints and
    sensor_origin: [3] the ray origin, both in the map frame."""
    res = vg.resolution
    hit_code = _pack(_cells(points, res))
    hit_delta = torch.where(point_valid, L_HIT, 0.0)

    if carve_free_space:
        # stratified samples strictly inside the ray (the endpoint voxel
        # excluded): t in (0, 1 - res/range)
        t = (torch.arange(ray_samples, dtype=torch.float32, device=points.device) + 0.5) / ray_samples
        ray = points - sensor_origin
        rng = torch.linalg.vector_norm(ray, dim=-1, keepdim=True)
        t_max = torch.clamp(1.0 - res / torch.clamp(rng, min=res), 0.0, 1.0)
        samples = sensor_origin + ray[:, None, :] * (t[None, :, None] * t_max[:, None, :])
        free_code = _pack(_cells(samples, res).reshape(-1, 3))
        # the miss is shared by the samples that fall in one voxel of a ray:
        # expected samples per voxel ~ S * res / range
        per_vox = torch.clamp(ray_samples * res / torch.clamp(rng[:, 0], min=res), min=1.0)
        free_delta = torch.where(
            point_valid[:, None], (L_MISS / per_vox[:, None]).expand(-1, ray_samples), 0.0
        ).reshape(-1)
        upd_code = torch.cat([hit_code, free_code])
        upd_delta = torch.cat([hit_delta, free_delta])
    else:
        upd_code, upd_delta = hit_code, hit_delta

    # existing records as (code, logodds)
    ex_code = torch.where(vg.valid, _pack(vg.keys), _KEY_SENT)
    ex_l = torch.where(vg.valid, _logodds(vg.occupancy), 0.0)
    upd_code = torch.where(upd_delta != 0.0, upd_code, _KEY_SENT)

    code = torch.cat([ex_code, upd_code])
    base = torch.cat([ex_l, torch.zeros_like(upd_delta)])
    delta = torch.cat([torch.zeros_like(ex_l), upd_delta])
    code_s, order = torch.sort(code, stable=True)
    M = code_s.shape[0]
    newseg = torch.ones(M, dtype=torch.bool, device=code.device)
    newseg[1:] = code_s[1:] != code_s[:-1]
    seg = torch.cumsum(newseg, dim=0) - 1

    def segment_sum(v):
        return torch.zeros(M, device=code.device).index_add(0, seg, v[order])

    logodds = torch.clamp(segment_sum(base) + segment_sum(delta), L_MIN, L_MAX)
    # one code per segment; ids past the last segment keep the sentinel
    seg_code = torch.full((M,), _KEY_SENT, dtype=torch.int64, device=code.device)
    seg_code = seg_code.index_put((seg,), code_s)

    # keep the first C segments in code order (overflow drops the highest
    # codes; callers size the capacity)
    C = vg.keys.shape[0]
    take = torch.arange(min(C, M), device=code.device)
    k = seg_code[take]
    valid_out = k != _KEY_SENT
    k1, k2 = k // (1 << 31), k % (1 << 31)
    keys_out = torch.stack([k1 // (1 << 15) - _OFF, k1 % (1 << 15) - _OFF, k2 - _OFF], dim=-1)
    keys_out = torch.where(valid_out[:, None], keys_out, 0).to(torch.int32)
    occ_out = torch.where(valid_out, torch.sigmoid(logodds[take]), 0.5)
    if C > M:
        keys_out = torch.cat([keys_out, torch.zeros(C - M, 3, dtype=torch.int32,
                                                   device=code.device)])
        occ_out = torch.cat([occ_out, torch.full((C - M,), 0.5, device=code.device)])
        valid_out = torch.cat([valid_out, torch.zeros(C - M, dtype=torch.bool,
                                                     device=code.device)])
    return VoxelGridLayer(keys=keys_out, occupancy=occ_out, valid=valid_out, resolution=res)


def lookup_occupancy(vg: VoxelGridLayer, points: torch.Tensor, default: float = 0.5) -> torch.Tensor:
    """Occupancy of the voxel that holds each point [N, 3] -> [N]
    (``default`` where no valid record holds it): a sort of the records'
    codes and a binary search, where the JAX package compares chunks of
    points against every record."""
    codes = torch.where(vg.valid, _pack(vg.keys), _KEY_SENT)
    s_codes, order = torch.sort(codes)
    q = _pack(_cells(points, vg.resolution)).contiguous()
    pos = torch.clamp(torch.searchsorted(s_codes, q), max=s_codes.shape[0] - 1)
    hit = s_codes[pos] == q
    return torch.where(hit, vg.occupancy[order[pos]], default)
