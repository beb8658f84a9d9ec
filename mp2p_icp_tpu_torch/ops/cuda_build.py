"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is compiled on first use, from ``mp2p_icp_tpu_torch/csrc`` only,
into ``build/`` at the repository root, as a shared library with a plain C
interface. The file name carries a hash of the sources, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. ``build()`` starts one nvcc per library,
all at once. Nothing here runs at import time: the CPU tests import every
module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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
}

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


def build_record(name: str) -> dict:
    """Path, build seconds (wall time of the parallel build it was part
    of), whether this process compiled it, and nvcc's ptxas report
    (registers, shared memory, spills)."""
    return dict(_BUILT[name])
