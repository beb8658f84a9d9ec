"""The host side of the package's hand-written CUDA kernels: build, load,
launch and count.

Each library is compiled on first use, from ``mp2p_icp_tpu_torch/csrc`` only,
into ``build/`` at the repository root, as a shared library with a plain C
interface. The file name carries a hash of the sources, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. ``build()`` starts one nvcc per library,
all at once. Nothing here runs at import time: the CPU tests import every
module on a machine without nvcc.

Every kernel is launched through ``launch``, which checks and flattens its
tensors by the kernel's own table (``Kernel``), calls its entry point on
the device's current stream, raises on a CUDA error and counts the launch
in ``launches`` under its library's name. ``launch_arg`` gives a custom
operator's tensors, and its vmap rule's, the form ``launch`` takes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
# library name -> its sources in csrc/
LIBRARIES = {
    "knn_bruteforce": ("knn_bruteforce.cu",),
    "knn_streamed": ("knn_streamed.cu",),
    "knn_batched": ("knn_batched.cu",),
    "gn_solve": ("gn_solve.cu",),
    "icp_terminate": ("icp_terminate.cu",),
}

# library name -> the launches of its kernel since the last reset_launches();
# a launch is one call of the entry point (a sweep and its merge count as one)
launches = dict.fromkeys(LIBRARIES, 0)

# name -> (ctypes.CDLL, build record); one load per process
_LOADED: dict = {}
# name -> build record of a library this process compiled or found built
_BUILT: dict = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH); the CUDA kernels "
            "of mp2p_icp_tpu_torch are built with it on first use"
        )
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC_DIR / s for s in LIBRARIES[name]] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(LIBRARIES)) -> None:
    """Compile every named library that is not built yet, one nvcc process
    each, all started together; raises with nvcc's output if any fails."""
    todo = {}
    for name in names:
        if name in _BUILT:
            continue
        out = _target(name)
        if out.exists():
            _BUILT[name] = {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
        else:
            todo[name] = out
    if not todo:
        return
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC_DIR / s) for s in LIBRARIES[name])]
        procs[name] = (tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, cmd, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed (exit {proc.returncode}) building {name}:\n"
                          f"{' '.join(cmd)}\n{stderr}")
            continue
        os.replace(tmp, todo[name])
        _BUILT[name] = {"path": str(todo[name]), "seconds": time.perf_counter() - t0,
                        "built": True, "log": (stdout + stderr).strip()}
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``build/lib<name>-<hash>.so``."""
    if name not in _LOADED:
        build((name,))
        _LOADED[name] = ctypes.CDLL(_BUILT[name]["path"])
    return _LOADED[name]


@functools.lru_cache(maxsize=None)
def entry_point(name: str, symbol: str, argtypes: tuple):
    """The C function ``symbol`` of library ``name``, built and loaded on
    first use, its argument types set once; it returns an int (a CUDA
    error code, 0 on success)."""
    fn = getattr(load_library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def build_record(name: str) -> dict:
    """Path, build seconds (wall time of the parallel build it was part
    of), whether this process compiled it, and nvcc's ptxas report
    (registers, shared memory, spills)."""
    return dict(_BUILT[name])


def reset_launches() -> None:
    """Sets every library's launch count to 0."""
    launches.update(dict.fromkeys(LIBRARIES, 0))


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A hand-written kernel's C entry point as ``launch`` calls it.

    ``library``: its key in ``LIBRARIES``. ``tensors``: its leading
    arguments in the C order. An entry (name, shape of one problem) is a
    float32 tensor, passed as its pointer and batch stride. Its first dim
    may be a block's name: the block's rows, the same in each of the
    block's tensors (0 where they are None), which the bare name passes as
    an int after the block's tensors. ``scalars``: the ctypes of
    the arguments after them, outputs included; the stream comes last."""

    library: str
    symbol: str
    tensors: tuple
    scalars: tuple

    @functools.cached_property
    def fn(self):
        """The entry point, built and loaded on first use."""
        argtypes = []
        for spec in self.tensors:
            argtypes += [_I] if isinstance(spec, str) else [_P, _L]
        return entry_point(self.library, self.symbol, (*argtypes, *self.scalars, _P))


def launch(kernel: Kernel, dev: torch.device, B: int, tensors, *rest) -> None:
    """One launch of ``kernel`` for B problems on ``dev``'s current stream,
    counted in ``launches``. ``tensors``: one per tensor of
    ``kernel.tensors``, (tensor, batched) or None (a null pointer): a
    batched tensor has a leading B, an unbatched one is shared by every
    problem (batch stride 0). Raises ValueError, naming the tensor, where
    one is not contiguous float32 of its shape on ``dev``. ``rest``: the
    arguments of ``kernel.scalars``; a tensor among them passes its
    pointer, None a null one. Raises RuntimeError on a CUDA error."""
    if dev.type != "cuda":
        raise ValueError(f"the {kernel.library} kernel runs on the card, not on {dev}")
    flat, rows, missing = [], {}, set()
    given = iter(tensors)
    for spec in kernel.tensors:
        if isinstance(spec, str):  # a block's rows, after its tensors
            if spec in rows and spec in missing:
                raise ValueError("a block's tensors are all given or all None")
            flat.append(rows.get(spec, 0))
            continue
        name, shape = spec
        a = next(given)
        if a is None:
            missing.add(shape[0])
            flat += [None, 0]
            continue
        x, batched = a
        lead = (B,) if batched else ()
        if isinstance(shape[0], str):
            n = x.shape[len(lead)] if x.ndim > len(lead) else None
            shape = (rows.setdefault(shape[0], n),) + shape[1:]
        want = lead + shape
        if (x.dtype != torch.float32 or x.device != dev or x.shape != want
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {want} on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        flat += [x.data_ptr(), x.stride(0) if batched else 0]
    with torch.cuda.device(dev):
        err = kernel.fn(*flat, *(x.data_ptr() if isinstance(x, torch.Tensor) else x
                                 for x in rest),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel.library} kernel launch failed: CUDA error {err}")
    launches[kernel.library] += 1


def launch_arg(x, in_dim=None):
    """A custom operator's tensor as ``launch`` takes it: (x, batched),
    contiguous, with the batch dim ``in_dim`` of a vmap rule moved to the
    front; None stays None."""
    if x is None:
        return None
    if in_dim is None:
        return x.contiguous(), False
    return x.movedim(in_dim, 0).contiguous(), True
