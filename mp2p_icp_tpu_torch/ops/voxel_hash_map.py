"""Incremental voxel hash map: map maintenance in O(new points) per frame.

Port of ``mp2p_icp_tpu/ops/voxel_hash_map.py`` (reference: the spatial hash
of PointCloudToVoxelGrid.h:88-116, Teschner constants 73856093 / 19349663 /
83492791). An open-address hash table sits on the device next to the point
buffer:

- state = a fixed-capacity point buffer (one representative per occupied
  voxel, in insertion order: the FirstPoint winner is the earliest inserted
  point) + two [T] key tables (the exact 45-bit voxel key in two int32
  words, the packing of ``ops/voxel_unique.py``: no aliasing of voxels);
- insert = lockstep parallel linear probing. In each round every pending
  point reads its probe slot; an equal key resolves it as a duplicate; an
  empty slot is claimed by a scatter-min of the point index, and the winner
  writes its key. All points with one key share one probe sequence and the
  rounds are lockstep, so the linear-probing invariant holds (a key lives
  at the first empty slot of its sequence at insert time; no deletions)
  and lookups are exact.

The JAX package runs the rounds in a ``lax.while_loop`` on ``any(pending)``.
Here each test of that condition is a device-to-host sync, so the first
``ROUNDS_BEFORE_CHECK`` rounds run unconditionally. A round with nothing
pending changes nothing, so the result is the same for any number of
rounds; the state is equal to the JAX package's, table slot for table slot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.core.pointcloud import PointCloud, scatter_rows
from mp2p_icp_tpu_torch.device import resolve
from mp2p_icp_tpu_torch.ops.voxel_unique import SENTINEL, key_words, voxel_cells
from mp2p_icp_tpu_torch.utils.profiler import profile_scope, spanned

_HX = 73856093
_HY = 19349663
_HZ = 83492791
_U32 = 0xFFFFFFFF
# probe rounds run before the first any(pending) is read back: a street
# sweep resolves in 2-3 rounds
ROUNDS_BEFORE_CHECK = 2


class VoxelHashMapState(NamedTuple):
    """Rolling voxel-unique map: point buffer + exact-key hash table.

    pc:        PointCloud — one representative point per occupied voxel, in
               insertion order (FirstPoint semantics).
    table_k1:  [T] int32 — key word 1 per slot (SENTINEL = empty).
    table_k2:  [T] int32 — key word 2 per slot.
    n_dropped: scalar int32 — points that won a voxel but overflowed the
               buffer, or whose probe chain ran out (the voxel stays open).
    """

    pc: PointCloud
    table_k1: torch.Tensor
    table_k2: torch.Tensor
    n_dropped: torch.Tensor


def table_size_for(capacity: int) -> int:
    """Power-of-two table >= 4x capacity (load factor <= 0.25 keeps the
    expected probe chain ~1.2 slots)."""
    ts = 1024
    while ts < 4 * capacity:
        ts *= 2
    return ts


def empty_voxel_hash_map(
    capacity: int,
    table_size: Optional[int] = None,
    intensity: bool = False,
    ring: bool = False,
    time: bool = False,
    normals: bool = False,
    device=None,
    batch: tuple = (),
) -> VoxelHashMapState:
    """An empty map; ``batch=(B,)`` gives B independent maps (a leading
    axis on every tensor of the state)."""
    device = resolve(device)
    T = table_size or table_size_for(capacity)
    batch = tuple(batch)

    def zeros(on, *width):
        return torch.zeros(batch + (capacity,) + width, device=device) if on else None

    pc = PointCloud(
        xyz=torch.full(batch + (capacity, 3), PointCloud.PAD_VALUE, device=device),
        count=torch.zeros(batch, dtype=torch.int32, device=device),
        intensity=zeros(intensity),
        ring=zeros(ring),
        time=zeros(time),
        normals=zeros(normals, 3),
    )
    return VoxelHashMapState(
        pc=pc,
        table_k1=torch.full(batch + (T,), SENTINEL, dtype=torch.int32, device=device),
        table_k2=torch.full(batch + (T,), SENTINEL, dtype=torch.int32, device=device),
        n_dropped=torch.zeros(batch, dtype=torch.int32, device=device),
    )


def _mul_u32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for int64 h in [0, 2^32) and c < 2^32, in two
    halves so that no product leaves int64 (torch has no uint32 products)."""
    return ((h & 0xFFFF) * c + ((((h >> 16) * c) & 0xFFFF) << 16)) & _U32


def voxel_keys(xyz: torch.Tensor, valid: torch.Tensor, resolution):
    """The exact two-word voxel key (k1, k2: int32, SENTINEL on invalid
    rows) and the hash of the cell (int32; callers mask it to the table
    size): the Teschner XOR of the int32-wrapped products, then the murmur3
    finaliser in 32-bit unsigned arithmetic (the raw XOR clusters on the
    thin shells a LiDAR sweep fills). Computed in int64 masked to 32 bits,
    bit-equal to the JAX package's uint32 arithmetic. xyz [..., N, 3] and
    valid [..., N] give [..., N] words."""
    cells = voxel_cells(xyz, resolution)
    k1, k2 = key_words(cells, valid)
    h = ((cells[..., 0] * _HX) ^ (cells[..., 1] * _HY) ^ (cells[..., 2] * _HZ)) & _U32
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return k1.to(torch.int32), k2.to(torch.int32), h.to(torch.int32)


@spanned("map.insert")
def hash_map_insert(
    state: VoxelHashMapState,
    new: PointCloud,
    resolution,
    valid: Optional[torch.Tensor] = None,
    max_probe: int = 12,
    with_dest: bool = False,
):
    """Insert the valid points of ``new``; a point lands in the buffer iff
    its voxel is unoccupied (FirstPoint, insertion order: earlier buffer
    rows, then the lower input index, win). Returns a new state; ``state``
    is left as it was.

    A stacked state (tables [B, T], buffers [B, C, ...]) takes a stacked
    cloud [B, N, 3]: B independent inserts, each into its own table and
    buffer. The probe rounds run for all of them together and the host
    reads ``any(pending)`` once per round for the whole batch; a round
    changes nothing for a map with nothing pending, so each map's state is
    that of its own insert whatever the others need. ``n_dropped``, ``dest``
    and the rollback on a full buffer are per map. One map is the batch of
    one.

    valid: optional explicit mask (default: new.valid_mask()).
    with_dest: also return the [..., N] int64 buffer row each input point
    landed in (C = not inserted), so that callers can post-process the
    winners only (the normals fit of the newly inserted map points)."""
    if valid is None:
        valid = new.valid_mask()
    if new.xyz.ndim == 2:
        lift = lambda x: x[None]  # noqa: E731
        out, dest = _insert_batched(pytree.tree_map(lift, state), pytree.tree_map(lift, new),
                                    resolution, valid[None], max_probe)
        out, dest = pytree.tree_map(lambda x: x[0], out), dest[0]
    else:
        out, dest = _insert_batched(state, new, resolution, valid, max_probe)
    return (out, dest) if with_dest else out


def _insert_batched(state, new, resolution, valid, max_probe):
    """``hash_map_insert`` on stacked inputs. The B tables lie end to end
    in one flat table of B·(T+1) slots (map b at offset b·(T+1)), so that
    every gather and scatter of a round serves all maps at once."""
    B, T = state.table_k1.shape
    C = state.pc.capacity
    N = new.capacity
    dev = new.device
    smask = T - 1

    k1, k2, h = voxel_keys(new.xyz, valid, resolution)
    slot0 = (h & smask).long()
    idx = torch.arange(N, device=dev).expand(B, N)
    base = torch.arange(B, device=dev)[:, None] * (T + 1)
    # each table with one more slot, T, where every scatter sends the rows
    # that must not write
    empty = torch.full((B, 1), SENTINEL, dtype=torch.int32, device=dev)
    tk1 = torch.cat([state.table_k1, empty], dim=1).reshape(-1)
    tk2 = torch.cat([state.table_k2, empty], dim=1).reshape(-1)
    dump = (base + T).expand(B, N)
    # Per-point probe pointer: a point advances past a slot only when it
    # holds a different key; the loser of a claim looks at the same slot
    # again in the next round (it may now hold this point's own key: a
    # duplicate). max_probe bounds a point's chain; the rounds, bounded by
    # chain + contention, end as soon as nothing is pending.
    pending = valid
    probe = torch.zeros((B, N), dtype=torch.int64, device=dev)
    win_slot = torch.full((B, N), T, dtype=torch.int64, device=dev)
    exhausted_n = torch.zeros(B, dtype=torch.int32, device=dev)
    for rounds in range(4 * max_probe):
        # one read for the whole batch
        if rounds >= ROUNDS_BEFORE_CHECK:
            any_pending = pending.any()
            with profile_scope("sync.map_probe"):
                if not bool(any_pending):
                    break
        slot = (slot0 + probe) & smask
        flat = base + slot
        g1 = tk1[flat]
        g2 = tk2[flat]
        is_dup = pending & (g1 == k1) & (g2 == k2)
        is_empty = pending & (g1 == SENTINEL)
        occupied_other = pending & ~is_dup & ~is_empty
        # claim empty slots: the lowest pending point index wins the round
        claim = torch.full((B * (T + 1),), N, dtype=torch.int64, device=dev).scatter_reduce_(
            0, torch.where(is_empty, flat, dump).reshape(-1),
            torch.where(is_empty, idx, N).reshape(-1), "amin", include_self=True)
        winner = is_empty & (claim[flat] == idx)
        wslot = torch.where(winner, flat, dump).reshape(-1)
        tk1.index_copy_(0, wslot, torch.where(winner, k1, SENTINEL).reshape(-1))
        tk2.index_copy_(0, wslot, torch.where(winner, k2, SENTINEL).reshape(-1))
        win_slot = torch.where(winner, slot, win_slot)
        pending = pending & ~is_dup & ~winner
        probe = probe + occupied_other
        # chain exhausted: drop (pathological table fill)
        exhausted = pending & (probe >= max_probe)
        pending = pending & ~exhausted
        exhausted_n = exhausted_n + torch.sum(exhausted, dim=1, dtype=torch.int32)
    # unresolved after the round bound counts as dropped, like exhaustion
    exhausted_n = exhausted_n + torch.sum(pending, dim=1, dtype=torch.int32)

    # buffer rows are assigned after the probe loop, in input order: winners
    # delayed by collision chains still land in insertion order, the
    # reference's FirstPoint scan order
    winner = win_slot < T
    rank = torch.cumsum(winner, dim=1) - 1
    dest = state.pc.count[:, None] + rank
    keep = winner & (dest < C)
    # buffer overflow rolls the table write back: the voxel stays open for
    # a later frame with free space
    rb_slot = torch.where(winner & ~keep, base + win_slot, dump).reshape(-1)
    tk1.index_fill_(0, rb_slot, SENTINEL)
    tk2.index_fill_(0, rb_slot, SENTINEL)
    dest = torch.where(keep, dest, C)
    count = state.pc.count + torch.sum(keep, dim=1, dtype=torch.int32)
    dropped = (state.n_dropped + exhausted_n
               + torch.sum(winner & ~keep, dim=1, dtype=torch.int32))

    pc = state.pc

    def merge_ch(t_ch, s_ch, *width):
        if t_ch is None and s_ch is None:
            return None
        t = t_ch if t_ch is not None else torch.zeros((B, C) + width, device=dev)
        s = s_ch if s_ch is not None else torch.zeros((B, N) + width, device=dev)
        return scatter_rows(t, dest, s)

    out = VoxelHashMapState(
        pc=PointCloud(
            xyz=scatter_rows(pc.xyz, dest, new.xyz),
            count=count,
            intensity=merge_ch(pc.intensity, new.intensity),
            ring=merge_ch(pc.ring, new.ring),
            time=merge_ch(pc.time, new.time),
            normals=merge_ch(pc.normals, new.normals, 3),
        ),
        table_k1=tk1.view(B, T + 1)[:, :T], table_k2=tk2.view(B, T + 1)[:, :T],
        n_dropped=dropped,
    )
    return out, dest


def hash_decimate_first_point(
    new: PointCloud,
    resolution,
    output_capacity: int,
    valid: Optional[torch.Tensor] = None,
    table_size: Optional[int] = None,
    max_probe: int = 12,
) -> PointCloud:
    """One-shot FirstPoint voxel decimation through a scratch hash table
    (``FilterDecimateVoxels(backend='hash')``). Winner per voxel = lowest
    input index (the reference's insertion-order FirstPoint,
    FilterDecimateVoxels.cpp:244-270); output rows keep the winners' input
    order. Channels ride along."""
    state = empty_voxel_hash_map(
        output_capacity,
        table_size=table_size,
        intensity=new.intensity is not None,
        ring=new.ring is not None,
        time=new.time is not None,
        normals=new.normals is not None,
        device=new.device,
        batch=new.xyz.shape[:-2],
    )
    return hash_map_insert(
        state, new, resolution, valid=valid, max_probe=max_probe
    ).pc
