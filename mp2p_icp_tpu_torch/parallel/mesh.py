"""The (data, space) layout of ranks, and the collectives over its axes.

Port of ``mp2p_icp_tpu/parallel/mesh.py``. The JAX package runs a sharded
path as one SPMD program (``shard_map``) over a device ``Mesh`` with the
axes ``data`` (independent registrations) and ``space`` (the shards of one
global map). Here each rank is a process on its own device, started by
``torch.distributed`` (``parallel/multihost.py``, ``parallel/launch.py``),
and a mesh axis is a process group with this rank's index on it:

- ``lax.axis_index(axis)``  -> ``MeshAxis.rank``;
- ``lax.all_gather(x, axis)`` -> ``all_gather(x, axis)``: [n, ...] in rank
  order;
- ``lax.psum(x, axis)`` -> ``all_reduce_sum(x, axis)``: the ranks' parts
  added one after another in rank order, so every rank gets the same bits
  and two runs give the same sums.

Ranks are laid out [n_data, n_space] row-major: rank r has data index
r // n_space and space index r % n_space.

The backend is chosen where the process group starts, never here: NCCL
where every rank has its own card; gloo on the CPU and for several ranks on
one card (NCCL refuses two ranks on one GPU). On a gloo group a CUDA tensor
goes through the host, explicitly and always: the collective runs on a host
copy and its result is copied back to the tensor's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of the mesh as this rank sees it: the matchers'
    ``spatial_axis`` field holds one (the JAX package's holds its name)."""

    name: str
    size: int
    rank: int  # this rank's index on the axis
    group: object = None  # the process group; None when size == 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The two axes of this rank."""

    data: MeshAxis
    space: MeshAxis

    axis_names = ("data", "space")

    @property
    def shape(self) -> dict:
        return {"data": self.data.size, "space": self.space.size}

    def axis(self, name: str) -> MeshAxis:
        if name not in self.axis_names:
            raise ValueError(f"no mesh axis {name!r}; the axes are {self.axis_names}")
        return getattr(self, name)


def world() -> tuple:
    """(world size, this rank): (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(n_data: Optional[int] = None, n_space: int = 1) -> Mesh:
    """The [n_data, n_space] mesh over every rank of the process group (a
    mesh of one rank without one). Every rank must call it, with the same
    arguments: each creates every group of both axes, in the same order."""
    size, rank = world()
    if n_data is None:
        n_data = size // n_space
    if n_data * n_space != size:
        raise ValueError(f"mesh {n_data}x{n_space} needs {n_data * n_space} ranks, "
                         f"have {size}")
    d, s = divmod(rank, n_space)
    space = data = None
    if n_space > 1:
        for row in range(n_data):
            g = dist.new_group([row * n_space + c for c in range(n_space)])
            space = g if row == d else space
    if n_data > 1:
        for col in range(n_space):
            g = dist.new_group([r * n_space + col for r in range(n_data)])
            data = g if col == s else data
    return Mesh(data=MeshAxis("data", n_data, d, data),
                space=MeshAxis("space", n_space, s, space))


def all_gather(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """[axis.size, *x.shape]: x of every rank on the axis, in rank order."""
    if axis.size == 1:
        return x[None]
    src = x.reshape(-1)
    if x.is_cuda and dist.get_backend(axis.group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src.contiguous(), group=axis.group)
    return torch.stack(parts).to(x.device).reshape((axis.size,) + x.shape)


def all_reduce_sum(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """The sum of x over the ranks of the axis, added in rank order (the
    same on every rank and in every run). x itself without an axis."""
    if axis is None or axis.size == 1:
        return x
    parts = all_gather(x, axis)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def shard_batch(mesh: Mesh, tree, batch_axis: int = 0):
    """This rank's rows of a batched pytree: its data index's contiguous
    block of the leading axis (the same rows on every rank of a ``space``
    group). The batch must split evenly."""
    if batch_axis != 0:
        raise ValueError("shard_batch splits the leading axis only")
    n, d = mesh.data.size, mesh.data.rank

    def take(x):
        if not isinstance(x, torch.Tensor) or x.ndim == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over {n} data ranks")
        rows = x.shape[0] // n
        return x[d * rows:(d + 1) * rows]

    return pytree.tree_map(take, tree)
