"""mp2p_icp_tpu_torch — the PyTorch port of ``mp2p_icp_tpu``.

The layout mirrors the JAX package module for module (``core/se3.py``,
``matchers/adaptive.py``, ...), so each port has an obvious counterpart. The
JAX package stays the reference: every ported module is tested against it
on the CPU with the same numpy inputs.

What runs on the GPU: the exact brute-force kNN sweeps are CUDA kernels
written for Hopper (``csrc/knn_*.cu``, built with nvcc on first use);
everything around them is plain PyTorch on the tensors' own device.

Constructors put their tensors on ``default_device()``: the card, unless
the caller passes ``device=`` or has called ``set_default_device("cpu")``.

This package imports torch and numpy only, never jax.
"""

__version__ = "0.1.0"

import torch as _torch

# Pose and solver math is tiny (3x3 / 4x4 / 6x6) but accuracy-critical:
# TF32 keeps ~3 decimal digits, enough to break SE(3) exp/log round-trips.
# Pin full f32, as mp2p_icp_tpu/__init__.py pins "highest" for XLA.
_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from mp2p_icp_tpu_torch.device import default_device, set_default_device  # noqa: E402,F401
from mp2p_icp_tpu_torch.core import se3  # noqa: E402,F401
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud  # noqa: E402,F401
