"""Convert pt2pl / pt2ln pairings into virtual pt2pt pairs for Horn.

Port of ``mp2p_icp_tpu/solvers/pt2_conversions.py`` (reference:
pt2ln_pl_to_pt2pt.cpp:25-113): project the guess-transformed local point
onto its plane/line to make a virtual global point, then keep the pairs
whose error is at least ``RATIO`` of the block's largest (all valid pairs
when fewer than ``MIN_KEEP`` pass).
"""

from __future__ import annotations

import dataclasses

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pairings import Pairings, PairsPt2Pt
from mp2p_icp_tpu_torch.core.se3 import Pose

RATIO = 0.25
MIN_KEEP = 3


def pt2ln_pl_to_pt2pt(pairings: Pairings, guess: Pose) -> Pairings:
    """A Pairings whose pt2pt block is the original pt2pt pairs followed by
    the virtual pairs from pt2pl and pt2ln; those two blocks are emptied."""
    p = pairings.pt2pt
    blocks = [(p.local, p.globl, p.weight, p.local_idx, p.global_idx)]

    s = pairings.pt2pl
    if s.capacity > 1:
        pt_g = se3.apply(guess, s.local)
        d = torch.sum(s.plane_normal * (pt_g - s.plane_centroid), dim=-1)
        virtual_global = pt_g - s.plane_normal * d[:, None]
        blocks.append((s.local, virtual_global,
                       _band_filter_weights(s.weight, torch.abs(d)),
                       s.local_idx, torch.full_like(s.local_idx, -1)))

    q = pairings.pt2ln
    if q.capacity > 1:
        pt_g = se3.apply(guess, q.local)
        along = torch.sum(q.line_dir * (pt_g - q.line_point), dim=-1, keepdim=True)
        closest = q.line_point + q.line_dir * along
        d = torch.linalg.vector_norm(closest - pt_g, dim=-1)
        blocks.append((q.local, closest, _band_filter_weights(q.weight, d),
                       q.local_idx, torch.full_like(q.local_idx, -1)))

    new_pt2pt = PairsPt2Pt(
        *(torch.cat([b[i] for b in blocks], dim=0) for i in range(5))
    )
    device = p.weight.device
    return dataclasses.replace(
        pairings,
        pt2pt=new_pt2pt,
        pt2ln=type(pairings.pt2ln).empty(1, device),
        pt2pl=type(pairings.pt2pl).empty(1, device),
    )


def _band_filter_weights(weight: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    """Keep pairs with err >= RATIO * max_err; if that leaves < MIN_KEEP
    pairs, keep all valid pairs instead."""
    valid = weight > 0
    max_err = torch.max(torch.where(valid, err, -torch.inf))
    keep = valid & (err >= RATIO * torch.clamp(max_err, min=0.0))
    enough = torch.sum(keep, dtype=torch.int32) >= MIN_KEEP
    return weight * torch.where(enough, keep, valid)
