"""OLAE: the closed-form optimal-attitude solver.

Port of ``mp2p_icp_tpu/solvers/olae.py`` (reference:
optimal_tf_olae.cpp:65-361): the attitude-profile matrix B = Σ w b rᵀ over
unit vector pairs gives a Gibbs-vector linear system M g = v; three
sequential-rotation alternates (the problem pre-rotated by 180° about x, y
or z, [shuster1981attitude]) avoid the Gibbs singularity at θ = π. The
four 3x3 systems are solved together and the one with the largest |det M|
wins (a candidate with |det| < 1e-20 is regularised by 1e-9·I so that the
batched solve never fails). Run through ``solvers.solver.solve_in_f64``.
"""

from __future__ import annotations

from typing import Optional

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pairings import Pairings
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.solvers.common import (
    VectorPairs,
    WeightParameters,
    build_vector_pairs,
    translation_from_centroids,
)


def gibbs_to_rot(g: torch.Tensor) -> torch.Tensor:
    """Gibbs vector -> rotation matrix through the quaternion (1, -g)
    (reference: gibbs2pose, optimal_tf_olae.cpp:33-44, negates the vector
    part)."""
    return se3.quat_to_rot(torch.cat([torch.ones_like(g[..., :1]), -g], dim=-1))


def olae_systems(vp: VectorPairs):
    """The four Gibbs systems (M [4, 3, 3], v [4, 3]): the plain one and
    the alternates pre-rotated by 180° about x, y and z."""
    wn = vp.w / torch.clamp(torch.sum(vp.w), min=1e-30)
    B = torch.einsum("c,ci,cj->ij", wn, vp.b, vp.r)
    # v = -Σ w (b x r)  (the reference accumulates -= w * (b x r))
    v = -torch.einsum("c,ci->i", wn, torch.linalg.cross(vp.b, vp.r))
    S = B + B.T
    eye = torch.eye(3, dtype=B.dtype, device=B.device)
    p = torch.trace(B) + 1.0
    m = torch.trace(B) - 1.0
    M0 = S - p * eye
    z1, z2, z3 = v[0], v[1], v[2]

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    # the sequential-rotation alternates (reference: optimal_tf_olae.cpp:180-233)
    Mx = mat([[m, -z3, z2], [-z3, M0[2, 2], -S[1, 2]], [z2, -S[1, 2], M0[1, 1]]])
    vx = torch.stack([-z1, S[0, 2], -S[0, 1]])
    My = mat([[M0[2, 2], z3, -S[0, 2]], [z3, m, -z1], [-S[0, 2], -z1, M0[0, 0]]])
    vy = torch.stack([-S[1, 2], -z2, S[0, 1]])
    Mz = mat([[M0[1, 1], -S[0, 1], -z2], [-S[0, 1], M0[0, 0], z1], [-z2, z1, m]])
    vz = torch.stack([S[1, 2], -S[0, 2], -z3])

    return torch.stack([M0, Mx, My, Mz]), torch.stack([v, vx, vy, vz])


def olae_attitude(vp: VectorPairs) -> torch.Tensor:
    """The optimal rotation matrix from unit vector pairs: the solution of
    the best-conditioned system (largest |det M|)."""
    Ms, vs = olae_systems(vp)
    eye = torch.eye(3, dtype=Ms.dtype, device=Ms.device)
    dets = torch.abs(torch.linalg.det(Ms))
    reg = torch.where(dets < 1e-20, 1e-9, 0.0).to(Ms.dtype)
    # solve_ex: no host read of the solver's status on the card
    gs = torch.linalg.solve_ex(Ms + reg[:, None, None] * eye, vs[..., None])[0][..., 0]
    # pre-rotations identity, Rx(π), Ry(π), Rz(π), composed on the left
    pre = torch.diag_embed(torch.tensor(
        [[1.0, 1.0, 1.0], [1.0, -1.0, -1.0], [-1.0, 1.0, -1.0], [-1.0, -1.0, 1.0]],
        dtype=Ms.dtype, device=Ms.device))
    R_cands = se3.matmul3(pre, gibbs_to_rot(gs))
    return R_cands[torch.argmax(dets)]


def optimal_tf_olae(
    pairings: Pairings,
    wp: Optional[WeightParameters] = None,
    current_estimate: Optional[Pose] = None,
) -> Pose:
    """OLAE solve from raw pairings (pt2ln/pt2pl converted first, see
    pt2_conversions). All-zero weights give the identity."""
    vp = build_vector_pairs(
        pairings, wp or WeightParameters(), normalize_point_vectors=True,
        current_estimate=current_estimate,
    )
    R = olae_attitude(vp)
    t = translation_from_centroids(R, vp.ct_local, vp.ct_global)
    ok = torch.sum(vp.w) > 0
    return Pose(
        torch.where(ok, R, torch.eye(3, dtype=R.dtype, device=R.device)),
        torch.where(ok, t, torch.zeros_like(t)),
    )
