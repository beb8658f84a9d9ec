"""Multi-process start-up and the mesh across processes.

Port of ``mp2p_icp_tpu/parallel/multihost.py``. The JAX package starts
``jax.distributed`` from environment variables and lays a (data, space)
mesh over every process's devices. Here one process is one rank on one
device, and the same variables start a ``torch.distributed`` process group:

- ``MP2P_COORDINATOR`` (host:port of rank 0), ``MP2P_NUM_PROCESSES``,
  ``MP2P_PROCESS_ID``; ``MP2P_LOCAL_DEVICE_IDS`` (optional comma list)
  names the CUDA device of this process (its first entry);
- ``init_from_env(backend)`` starts the group with
  ``init_method="tcp://<coordinator>"``. The backend is the caller's
  argument (NCCL where every rank has its own card, gloo on the CPU and for
  several ranks on one card); a failed start raises and nothing switches
  backend;
- ``make_global_mesh`` keeps each ``space`` group inside one host (its
  per-align all_gathers stay off the network); ``data`` may span hosts;
- ``host_local_batch`` / ``fetch_replicated``: each rank feeds its own
  rows of a batch and gets the whole result back.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.device import set_default_device
from mp2p_icp_tpu_torch.parallel.mesh import Mesh, MeshAxis, all_gather, make_mesh, world

# how long a rank waits for the others at start-up and in a collective
TIMEOUT = datetime.timedelta(minutes=10)


def init_from_env(backend: str) -> bool:
    """Start the process group on ``backend`` when the MP2P_* variables ask
    for several processes. Returns True when running multi-process (after
    the start, or when a group already runs), False for one process (no
    side effects). Safe to call from every entry point."""
    coord = os.environ.get("MP2P_COORDINATOR")
    nproc = os.environ.get("MP2P_NUM_PROCESSES")
    if coord is None or nproc is None or int(nproc) <= 1:
        return False
    if dist.is_initialized():
        return True
    local_ids = [int(x) for x in os.environ.get("MP2P_LOCAL_DEVICE_IDS", "").split(",") if x]
    if local_ids:
        torch.cuda.set_device(local_ids[0])
        set_default_device(torch.device("cuda", local_ids[0]))
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coord}",
        world_size=int(nproc),
        rank=int(os.environ.get("MP2P_PROCESS_ID", "0")),
        timeout=TIMEOUT,
    )
    return True


def _ranks_per_host() -> int:
    """Ranks on this rank's host; every host must hold as many, with
    consecutive rank numbers (the order of the process ids)."""
    size, _ = world()
    if size == 1:
        return 1
    names = [None] * size
    dist.all_gather_object(names, socket.gethostname())
    per = names.count(names[0])
    blocks = [names[i:i + per] for i in range(0, size, per)]
    if size % per or any(len(set(b)) != 1 for b in blocks) or len({b[0] for b in blocks}) != len(blocks):
        raise ValueError(f"ranks are not host-major with equal counts per host: {names}")
    return per


def make_global_mesh(n_space: int = 1) -> Mesh:
    """(data, space) mesh over every rank, the ``space`` groups inside one
    host: n_space must divide the ranks per host, and the [n_data,
    n_space] row-major layout then keeps each space row on one host."""
    per_host = _ranks_per_host()
    if n_space > 1 and per_host % n_space != 0:
        raise ValueError(f"n_space={n_space} must divide the ranks per host ({per_host}) so "
                         "that the space axis stays on one host")
    return make_mesh(n_space=n_space)


def host_local_batch(mesh: Mesh, tree, batch_axis: int = 0):
    """Each rank passes only the batch rows it owns (those of its data
    index, in rank order) and aligns them on its own device: the rows are
    moved to the default device as they are. One process: the same."""
    del mesh, batch_axis  # a rank's rows are its whole batch
    from mp2p_icp_tpu_torch.device import default_device

    dev = default_device()
    return pytree.tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x, tree)


def fetch_replicated(x, mesh: Optional[Mesh] = None) -> np.ndarray:
    """The whole batch of a result on every rank, as numpy: the ranks'
    rows along the ``data`` axis of ``mesh`` (every rank without a mesh)
    concatenated in rank order along axis 0."""
    size, rank = world()
    if size == 1:
        return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    axis = mesh.data if mesh is not None else MeshAxis("world", size, rank, dist.group.WORLD)
    x = torch.as_tensor(x)
    parts = all_gather(x, axis)
    return parts.reshape((-1,) + tuple(x.shape[1:])).cpu().numpy()
