"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is compiled on first use, from ``mp2p_icp_tpu_torch/csrc`` only,
into ``build/`` at the repository root, as a shared library with a plain C
interface. The file name carries a hash of the sources and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Nothing
here runs at import time: the CPU tests import every module on a machine
without nvcc.
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

# name -> (ctypes.CDLL, build record); one load per process
_LOADED: dict = {}


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


def load_library(name: str, sources) -> ctypes.CDLL:
    """Compile (if needed) and load ``build/lib<name>-<hash>.so``."""
    if name in _LOADED:
        return _LOADED[name][0]
    paths = [CSRC_DIR / s for s in sources]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in paths:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    record = {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) building {name}:\n"
                f"{' '.join(cmd)}\n{proc.stderr}"
            )
        os.replace(tmp, out)
        record.update(
            seconds=time.perf_counter() - t0, built=True,
            log=(proc.stdout + proc.stderr).strip(),
        )
    lib = ctypes.CDLL(str(out))
    _LOADED[name] = (lib, record)
    return lib


def build_record(name: str) -> dict:
    """Path, build seconds, whether this process compiled it, and nvcc's
    ptxas report (registers, shared memory, spills) for a loaded library."""
    return dict(_LOADED[name][1])
