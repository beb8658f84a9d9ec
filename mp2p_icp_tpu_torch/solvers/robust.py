"""Robust kernel weight functions.

Port of ``mp2p_icp_tpu/solvers/robust.py`` (reference:
robust_kernels.h:33-103). The functions return the sqrt-weight applied to
each pairing's weight:

- GemanMcClure: w = c² / (e² + c)²   (the reference adds the unsquared c
  inside the square; reproduced as it is, for parity);
- Cauchy:       w = c² / (e² + c²)
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class RobustKernel(enum.Enum):
    NONE = "None"
    GEMAN_MCCLURE = "GemanMcClure"
    CAUCHY = "Cauchy"

    @staticmethod
    def from_string(s: str) -> "RobustKernel":
        """Parse 'RobustKernel::GemanMcClure' or a bare name."""
        s = s.split("::")[-1]
        for k in RobustKernel:
            if k.value.lower() == s.lower():
                return k
        raise ValueError(f"Unknown robust kernel: {s!r}")


def robust_sqrt_weight(
    kernel: RobustKernel, err_sqr: torch.Tensor, param: float
) -> torch.Tensor:
    """Vectorised sqrt-weight for a tensor of squared errors."""
    if kernel == RobustKernel.NONE:
        return torch.ones_like(err_sqr)
    # c and c² rounded to f32 as the JAX package computes them
    c32 = np.float32(param)
    c, c2 = float(c32), float(c32 * c32)
    if kernel == RobustKernel.GEMAN_MCCLURE:
        return c2 / torch.square(err_sqr + c)
    if kernel == RobustKernel.CAUCHY:
        return c2 / (err_sqr + c2)
    raise ValueError(f"Unknown robust kernel: {kernel}")
