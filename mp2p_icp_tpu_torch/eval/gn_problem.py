"""Synthetic Gauss-Newton problems: the live pt2pt / pt2pl blocks of one
solve, made from a seed.

The kernel's tests, ``chip_smoke.py``'s ``[gn]`` rows and
``scripts/torch_gn_reference.py`` (the JAX package's poses for the same
inputs) all build their problems here, so the three hold one generator.
The rows are drawn with numpy, so a seed gives the same float32 inputs on
every machine.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.utils._pytree as pytree

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pairings import Pairings, PairsPt2Pl, PairsPt2Pt

GT = (1.2, -0.4, 0.15, 0.06, -0.02, 0.03)  # x y z yaw pitch roll: local -> global
GUESS_T = (150.0, -40.0, 2.0)  # a scan-to-map pose far from the origin


def gn_problem(seed, n_pt=0, n_pl=0, valid=0.8, device="cpu"):
    """(pairings, guess): pt2pt rows paired with the true global point plus
    1 cm of noise, pt2pl rows with a plane through it (random unit normal,
    the centroid moved along the plane), ``valid`` of the rows weighted
    1 and the rest zero rows, as the matchers write them; the guess a few
    cm and mrad off the truth, 150 m from the origin. ``Pairings.live``
    names the blocks given (``n_pt``, ``n_pl`` > 0)."""
    rng = np.random.RandomState(seed)
    truth = se3.compose(se3.from_xyz_ypr(*GUESS_T, 0.0, 0.0, 0.0, device="cpu"),
                        se3.from_xyz_ypr(*GT, device="cpu"))

    def rows(n):
        local = torch.from_numpy(rng.uniform(-40, 40, (n, 3)).astype(np.float32))
        live = torch.from_numpy(rng.rand(n) < valid)
        glob = se3.apply(truth, local) + torch.from_numpy(
            rng.normal(0, 0.01, (n, 3)).astype(np.float32))
        return local, live, glob

    blocks = {}
    if n_pt:
        local, ok, glob = rows(n_pt)
        m = ok[:, None]
        blocks["pt2pt"] = PairsPt2Pt(
            local=torch.where(m, local, 0.0), globl=torch.where(m, glob, 0.0),
            weight=ok.float(), local_idx=torch.where(ok, torch.arange(n_pt), -1).int(),
            global_idx=torch.where(ok, torch.arange(n_pt), -1).int())
    if n_pl:
        local, ok, glob = rows(n_pl)
        n = torch.from_numpy(rng.normal(size=(n_pl, 3)).astype(np.float32))
        n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
        along = torch.linalg.cross(n, torch.from_numpy(
            rng.normal(size=(n_pl, 3)).astype(np.float32)))
        m = ok[:, None]
        blocks["pt2pl"] = PairsPt2Pl(
            local=torch.where(m, local, 0.0), plane_centroid=torch.where(m, glob + along, 0.0),
            plane_normal=torch.where(m, n, 0.0), weight=ok.float(),
            local_idx=torch.where(ok, torch.arange(n_pl), -1).int())
    pairings = dataclasses.replace(Pairings.empty(device="cpu"), **blocks,
                                   live=frozenset(blocks))
    guess = se3.compose(truth, se3.from_xyz_ypr(0.04, -0.03, 0.02, 0.004, -0.003, 0.002,
                                                device="cpu"))
    to = lambda x: x.to(device)  # noqa: E731
    return pytree.tree_map(to, pairings), pytree.tree_map(to, guess)
