"""Unified correspondence containers.

Port of ``mp2p_icp_tpu/core/pairings.py``: five fixed-capacity masked SoA
blocks (pt2pt, pt2ln, pt2pl, ln2ln, pl2pl) plus the potential-pairings
counter. Invalid rows carry zero weight (and index -1), so every solver
reduction is a masked weighted sum over the whole capacity. The blocks and
``Pairings`` are pytree nodes, so ``torch.func.vmap`` maps over them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.device import resolve


class _Block:
    """Shared accessors of the five pairing blocks. Fields named ``*_idx``
    are int32 [C] (-1 invalid), ``weight`` is [C], the rest are [C, 3]."""

    @property
    def capacity(self) -> int:
        return self.weight.shape[0]

    def valid(self) -> torch.Tensor:
        return self.weight > 0

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid(), dtype=torch.int32)

    @classmethod
    def empty(cls, capacity: int, device=None):
        device = resolve(device)
        out = {}
        for f in dataclasses.fields(cls):
            if f.name.endswith("idx"):
                out[f.name] = torch.full(
                    (capacity,), -1, dtype=torch.int32, device=device
                )
            elif f.name == "weight":
                out[f.name] = torch.zeros(capacity, device=device)
            else:
                out[f.name] = torch.zeros(capacity, 3, device=device)
        return cls(**out)


@dataclasses.dataclass(frozen=True)
class PairsPt2Pt(_Block):
    """Point-to-point pairs."""

    local: torch.Tensor  # [C, 3] local point (sensor frame)
    globl: torch.Tensor  # [C, 3] paired global point
    weight: torch.Tensor  # [C] (0 for invalid rows)
    local_idx: torch.Tensor  # [C] i32 index into the local layer (-1 invalid)
    global_idx: torch.Tensor  # [C] i32 index into the global layer (-1 invalid)


@dataclasses.dataclass(frozen=True)
class PairsPt2Pl(_Block):
    """Point-to-plane pairs."""

    local: torch.Tensor  # [C, 3]
    plane_centroid: torch.Tensor  # [C, 3]
    plane_normal: torch.Tensor  # [C, 3] unit
    weight: torch.Tensor  # [C]
    local_idx: torch.Tensor  # [C] i32


@dataclasses.dataclass(frozen=True)
class PairsPt2Ln(_Block):
    """Point-to-line pairs."""

    local: torch.Tensor  # [C, 3]
    line_point: torch.Tensor  # [C, 3]
    line_dir: torch.Tensor  # [C, 3] unit
    weight: torch.Tensor  # [C]
    local_idx: torch.Tensor  # [C] i32


@dataclasses.dataclass(frozen=True)
class PairsLn2Ln(_Block):
    """Line-to-line pairs."""

    local_point: torch.Tensor  # [C, 3]
    local_dir: torch.Tensor  # [C, 3]
    global_point: torch.Tensor  # [C, 3]
    global_dir: torch.Tensor  # [C, 3]
    weight: torch.Tensor  # [C]


@dataclasses.dataclass(frozen=True)
class PairsPl2Pl(_Block):
    """Plane-to-plane pairs."""

    local_normal: torch.Tensor  # [C, 3]
    local_centroid: torch.Tensor  # [C, 3]
    global_normal: torch.Tensor  # [C, 3]
    global_centroid: torch.Tensor  # [C, 3]
    weight: torch.Tensor  # [C]


BLOCK_TYPES = {
    "pt2pt": PairsPt2Pt,
    "pt2ln": PairsPt2Ln,
    "pt2pl": PairsPt2Pl,
    "ln2ln": PairsLn2Ln,
    "pl2pl": PairsPl2Pl,
}


def concat_blocks(blocks, cls, device=None):
    """Row-concatenate blocks of one type (an empty list gives a
    one-row empty block on ``device``)."""
    if not blocks:
        return cls.empty(1, device)
    return cls(
        **{
            f.name: torch.cat([getattr(b, f.name) for b in blocks], dim=0)
            for f in dataclasses.fields(cls)
        }
    )


def _decimate_block(block, capacity: int):
    """A block's valid rows, thinned by an even stride to at most
    ``capacity`` and moved to the front in their order; the rest filled
    with 0 (-1 for indices). A block of at most ``capacity`` rows is
    returned as it is. The compaction is a cumsum rank and a scatter (no
    host read), as in ``ICP._crop_globals``."""
    if block.capacity <= capacity:
        return block
    valid = block.valid()
    rank = torch.cumsum(valid, dim=-1) - 1
    total = torch.sum(valid, dim=-1)
    stride = torch.clamp((total + capacity - 1) // capacity, min=1)
    keep = valid & (rank % stride == 0)
    rank = torch.cumsum(keep, dim=-1) - 1
    count = torch.clamp(torch.sum(keep, dim=-1), max=capacity)
    n = block.capacity
    slot = torch.where(keep & (rank < capacity), rank, capacity)
    order = torch.zeros(capacity + 1, dtype=torch.int64, device=valid.device).scatter(
        0, slot, torch.arange(n, device=valid.device))[:capacity]
    live = torch.arange(capacity, device=valid.device) < count
    out = {}
    for f in dataclasses.fields(block):
        a = getattr(block, f.name)[order]
        fill = -1 if not a.is_floating_point() else 0
        out[f.name] = torch.where(live if a.ndim == 1 else live[:, None], a, fill)
    return type(block)(**out)


@dataclasses.dataclass(frozen=True)
class Pairings:
    """The correspondence set handed from matchers to solvers."""

    pt2pt: PairsPt2Pt
    pt2ln: PairsPt2Ln
    pt2pl: PairsPt2Pl
    ln2ln: PairsLn2Ln
    pl2pl: PairsPl2Pl
    potential_pairings: torch.Tensor  # scalar i32

    @staticmethod
    def empty(
        pt2pt_cap: int = 0,
        pt2ln_cap: int = 0,
        pt2pl_cap: int = 0,
        ln2ln_cap: int = 8,
        pl2pl_cap: int = 8,
        device=None,
    ) -> "Pairings":
        device = resolve(device)
        return Pairings(
            pt2pt=PairsPt2Pt.empty(max(pt2pt_cap, 1), device),
            pt2ln=PairsPt2Ln.empty(max(pt2ln_cap, 1), device),
            pt2pl=PairsPt2Pl.empty(max(pt2pl_cap, 1), device),
            ln2ln=PairsLn2Ln.empty(max(ln2ln_cap, 1), device),
            pl2pl=PairsPl2Pl.empty(max(pl2pl_cap, 1), device),
            potential_pairings=torch.tensor(0, dtype=torch.int32, device=device),
        )

    def size(self) -> torch.Tensor:
        """Total number of valid pairings."""
        return (
            self.pt2pt.count()
            + self.pt2ln.count()
            + self.pt2pl.count()
            + self.ln2ln.count()
            + self.pl2pl.count()
        )

    def empty_flag(self) -> torch.Tensor:
        return self.size() == 0

    def decimated(self, capacity: int) -> "Pairings":
        """Every block thinned to at most ``capacity`` valid rows by an even
        stride and compacted: the bounded per-iteration record of
        ``ICPParameters.record_pairings`` (the reference keeps the full
        Pairings per iteration, LogRecord.h:58-71)."""
        return Pairings(
            **{name: _decimate_block(getattr(self, name), capacity) for name in BLOCK_TYPES},
            potential_pairings=self.potential_pairings,
        )


for _cls in (*BLOCK_TYPES.values(), Pairings):
    pytree.register_dataclass(
        _cls, serialized_type_name=f"mp2p_icp_tpu_torch.{_cls.__name__}"
    )
