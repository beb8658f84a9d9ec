"""Run one function on several ranks, each a process of its own.

``spawn_ranks(fn, n, backend, args)`` starts n processes with
``torch.multiprocessing.spawn`` (start method ``spawn``: ``fn`` is pickled
by its qualified name, so it must be a module-level function of an
importable module, not of a script's ``__main__``). Each process takes its
device, starts the process group and calls ``fn(*args)``; the parent gets
the return values in rank order. An exception in any rank ends every rank
and is raised again in the parent.

Start-up, either way explicit about the backend:

- ``init="file"``: a ``FileStore`` in a fresh directory (what the tests
  use: no port can collide between test workers);
- ``init="env"``: the MP2P_* variables of ``parallel/multihost.py`` with a
  coordinator on a free localhost port, read by ``init_from_env``.

``device``: ``None`` for the caller's ``default_device()`` (``cuda``
unless set otherwise), ``"cpu"``, one CUDA device for every rank
(``"cuda:0"``: several ranks on one card, with gloo), or ``"cuda"`` for
``cuda:<rank>`` (one card per rank, with NCCL).
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mp2p_icp_tpu_torch.device import resolve, set_default_device
from mp2p_icp_tpu_torch.parallel.multihost import TIMEOUT, init_from_env


def free_port() -> int:
    """A localhost TCP port that was free a moment ago (bind to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_device(device: torch.device, rank: int) -> torch.device:
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank)
    return device


def _rank_main(rank, fn, n, backend, device, init, workdir, args):
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # n ranks share the machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    set_default_device(dev)
    if init == "env":
        os.environ["MP2P_PROCESS_ID"] = str(rank)
        if not init_from_env(backend):
            raise RuntimeError("init_from_env did not start the process group")
    else:
        dist.init_process_group(backend=backend, init_method=f"file://{workdir}/store",
                                world_size=n, rank=rank, timeout=TIMEOUT)
    try:
        out = fn(*args)
        with open(os.path.join(workdir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n: int, backend: str, args=(), device=None, init: str = "file",
                timeout: float = None):
    """[fn(*args) of rank 0, ..., of rank n-1], each run in its own process
    on its own rank of an n-rank group on ``backend``. ``timeout``: seconds
    after which every rank still running is killed and TimeoutError raised
    (ranks that wait on a collective another rank skipped hang, they do
    not fail)."""
    if init not in ("file", "env"):
        raise ValueError(f"init is 'file' or 'env', not {init!r}")
    device = resolve(device)  # the caller's default, not the new process's
    workdir = tempfile.mkdtemp(prefix="mp2p-ranks-")
    # only an env start touches the variables, so a file start may run beside it
    saved = {k: os.environ.get(k) for k in ("MP2P_COORDINATOR", "MP2P_NUM_PROCESSES",
                                             "MP2P_LOCAL_DEVICE_IDS")} if init == "env" else {}
    try:
        if init == "env":  # inherited by the spawned processes
            os.environ["MP2P_COORDINATOR"] = f"localhost:{free_port()}"
            os.environ["MP2P_NUM_PROCESSES"] = str(n)
            os.environ.pop("MP2P_LOCAL_DEVICE_IDS", None)
        ctx = mp.spawn(_rank_main, args=(fn, n, backend, device, init, workdir, args),
                       nprocs=n, join=False)
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(None if deadline is None else max(0.0, deadline - time.monotonic())):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
                raise TimeoutError(f"{n} ranks of {fn.__name__} still ran after {timeout} s")
        out = []
        for rank in range(n):
            with open(os.path.join(workdir, f"result-{rank}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(workdir, ignore_errors=True)
