"""Pose-graph optimisation (the SE(3) graph-SLAM back end).

Port of ``mp2p_icp_tpu/parallel/pose_graph.py``, with its design:

- the residuals r_ij = log(Z_ij^-1 T_i^-1 T_j) and their right-perturbation
  Jacobians (J_j = Jr^-1(r), J_i = -Jr^-1(r) Ad(T_j^-1 T_i)) of all edges
  at once;
- ``optimize_pose_graph``: Gauss-Newton on the dense [6N, 6N] normal
  system with Levenberg damping and a gauge prior on node 0, a Cholesky
  solve, a fixed number of iterations;
- ``optimize_pose_graph_cg``: the same Gauss-Newton with the normal system
  solved matrix-free by block-Jacobi preconditioned conjugate gradients
  (H·v edge by edge; a converged CG freezes by masks, as the JAX package's
  fixed trip count does);
- with a mesh axis, each rank holds its share of the edges and every
  edge-wise sum (H or H·v, g, the diagonal blocks, chi²) is reduced over
  the axis; ``optimize_pose_graph_sharded`` is the dense solve so.

Here the residuals and Jacobians are float32, as in the JAX package, and
every product and sum after them (the weighted Jacobians, H, g, chi², the
solves) is float64; the update is rounded to float32 once. The iteration
loop is a Python loop that reads nothing back from the device. Sums over
edges run in a fixed order: the per-edge terms are sorted once by the node
(or block) they land on, and ``torch.segment_reduce`` adds each one's terms
in edge order, so two runs, on the card as on the CPU, give the same bits
(a scatter-add on the card would add in the order of its atomics). The
dense H is written block by block straight into its [6N, 6N] layout.
Ranks' partial sums are added in rank order (``mesh.all_reduce_sum``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.parallel.mesh import MeshAxis, all_reduce_sum

_F64 = torch.float64


class PoseGraphEdges(NamedTuple):
    """Batched SE(3) constraints: T_i^-1 T_j ~ Z (the measurement)."""

    i: torch.Tensor  # [E] int source node
    j: torch.Tensor  # [E] int target node
    z: Pose  # measured relative poses, [E]
    information: torch.Tensor  # [E, 6, 6]
    valid: torch.Tensor  # [E] bool


def edge_residuals(poses: Pose, edges: PoseGraphEdges):
    """r [E, 6] and the Jacobians Ji, Jj [E, 6, 6] of all edges (float32)."""
    i, j = edges.i.long(), edges.j.long()
    rel = se3.compose(se3.inverse(Pose(poses.R[i], poses.t[i])), Pose(poses.R[j], poses.t[j]))
    r = se3.log(se3.compose(se3.inverse(edges.z), rel))
    Jr_inv = se3.se3_right_jacobian_inv(r)
    # de/dxi_i = -Jr^-1(r) Ad(T_j^-1 T_i) = -Jr^-1(r) Ad(rel^-1)
    Ji = -torch.matmul(Jr_inv, se3.adjoint(se3.inverse(rel)))
    return r, Ji, Jr_inv


def _edge_terms(poses: Pose, edges: PoseGraphEdges):
    """(r, Ji, Jj, Li, Lj) in float64, with L* = w J*ᵀ Ω (w: validity)."""
    r, Ji, Jj = (x.to(_F64) for x in edge_residuals(poses, edges))
    w = edges.valid.to(_F64)[:, None, None]
    info = edges.information.to(_F64)
    Li = w * torch.matmul(Ji.transpose(1, 2), info)
    Lj = w * torch.matmul(Jj.transpose(1, 2), info)
    return r, Ji, Jj, Li, Lj


def _chi2(r, edges: PoseGraphEdges) -> torch.Tensor:
    w = edges.valid.to(_F64)
    quad = torch.einsum("ea,eab,eb->e", r, edges.information.to(_F64), r)
    return torch.sum(w * quad)


class _Segments(NamedTuple):
    """Terms landing on the same key, in a fixed order: ``order`` sorts the
    stacked terms by key (stably: a key's terms keep their edge order),
    ``counts`` the terms of each distinct key, ``keys`` the keys."""

    order: torch.Tensor
    counts: torch.Tensor
    keys: torch.Tensor


def _segments(keys: torch.Tensor) -> _Segments:
    sorted_keys, order = torch.sort(keys, stable=True)
    uniq, counts = torch.unique_consecutive(sorted_keys, return_counts=True)
    return _Segments(order, counts, uniq)


def _sum_in_order(values: torch.Tensor, seg: _Segments) -> torch.Tensor:
    """[len(seg.keys), ...] sums of values [M, ...] by key, each key's
    terms added one after another in their order."""
    flat = values[seg.order].reshape(values.shape[0], -1)
    sums = torch.segment_reduce(flat, "sum", lengths=seg.counts, unsafe=True)
    return sums.reshape((seg.keys.shape[0],) + values.shape[1:])


class _Plan(NamedTuple):
    """The fixed order of the sums of one edge set (its topology never
    changes between iterations, so it is sorted once, before the loop)."""

    n: int
    nodes: _Segments  # of cat([i, j]): g, H·v, the diagonal blocks
    blocks: _Segments  # of cat([i·n+i, i·n+j, j·n+i, j·n+j]): the dense H


def _plan(edges: PoseGraphEdges, n: int, dense: bool = False) -> _Plan:
    i, j = edges.i.long(), edges.j.long()
    blocks = _segments(torch.cat([i * n + i, i * n + j, j * n + i, j * n + j])) if dense else None
    return _Plan(n, _segments(torch.cat([i, j])), blocks)


def _node_sums(plan: _Plan, at_i: torch.Tensor, at_j: torch.Tensor) -> torch.Tensor:
    """[N, ...]: each edge's at_i added to node i and at_j to node j."""
    sums = _sum_in_order(torch.cat([at_i, at_j]), plan.nodes)
    out = sums.new_zeros((plan.n,) + at_i.shape[1:])
    return out.index_put((plan.nodes.keys,), sums)


def _assemble(poses: Pose, edges: PoseGraphEdges, plan: _Plan, gauge_weight: float):
    """The dense normal system (H [6N, 6N], g [6N], chi²) of the edges."""
    n = plan.n
    r, Ji, Jj, Li, Lj = _edge_terms(poses, edges)
    Hij = torch.matmul(Li, Jj)
    blocks = torch.cat([torch.matmul(Li, Ji), Hij, Hij.transpose(1, 2), torch.matmul(Lj, Jj)])
    sums = _sum_in_order(blocks, plan.blocks)
    H = blocks.new_zeros((6 * n, 6 * n))
    keys = plan.blocks.keys
    # [N, N, 6, 6] view of H's storage: each distinct block written once
    H.view(n, 6, n, 6).permute(0, 2, 1, 3)[keys // n, keys % n] = sums
    H[:6, :6] += gauge_weight * torch.eye(6, dtype=_F64, device=H.device)  # gauge prior, node 0
    g = _node_sums(plan, torch.matmul(Li, r[..., None])[..., 0],
                   torch.matmul(Lj, r[..., None])[..., 0])
    return H, g.reshape(6 * n), _chi2(r, edges)


def _update(poses: Pose, delta: torch.Tensor) -> Pose:
    """poses ∘ exp(δ) per node, δ [N, 6] float64 rounded once to float32;
    a non-finite δ (a failed solve) moves nothing."""
    delta = torch.where(torch.isfinite(delta), delta, 0.0).to(poses.t.dtype)
    return se3.compose(poses, se3.exp(delta))


def _dense_step(poses, edges, plan, damping, gauge_weight, axis=None):
    """One Gauss-Newton step on the dense system: Cholesky of H + damping·I
    (the partial systems of the ranks summed first, the gauge added once).
    Returns (new poses, chi² before the step)."""
    H, g, chi2 = _assemble(poses, edges, plan, 0.0 if axis is not None else gauge_weight)
    if axis is not None:
        H, g, chi2 = (all_reduce_sum(x, axis) for x in (H, g, chi2))
        H[:6, :6] += gauge_weight * torch.eye(6, dtype=_F64, device=H.device)
    H.diagonal().add_(damping)
    L, _ = torch.linalg.cholesky_ex(H)
    delta = -torch.cholesky_solve(g[:, None], L)[:, 0]
    return _update(poses, delta.reshape(plan.n, 6)), chi2


@dataclasses.dataclass(frozen=True)
class PoseGraphParams:
    max_iterations: int = 10
    damping: float = 1e-6
    gauge_weight: float = 1e6


def optimize_pose_graph(poses: Pose, edges: PoseGraphEdges,
                        params: PoseGraphParams = PoseGraphParams()):
    """Dense Gauss-Newton pose-graph optimisation. Returns (poses, chi² at
    the returned poses)."""
    plan = _plan(edges, poses.t.shape[0], dense=True)
    for _ in range(params.max_iterations):
        poses, _ = _dense_step(poses, edges, plan, params.damping, params.gauge_weight)
    return poses, _chi2(_edge_terms(poses, edges)[0], edges)


def _hvp(plan: _Plan, edges: PoseGraphEdges, Ji, Jj, Li, Lj, v):
    """H @ v [N, 6] without H: per edge J v, then the weighted Jᵀ Ω (J v)
    summed onto both nodes."""
    i, j = edges.i.long(), edges.j.long()
    Jv = torch.matmul(Ji, v[i][..., None]) + torch.matmul(Jj, v[j][..., None])
    return _node_sums(plan, torch.matmul(Li, Jv)[..., 0], torch.matmul(Lj, Jv)[..., 0])


def _block_diag_sums(plan: _Plan, Ji, Jj, Li, Lj):
    """Each node's 6x6 diagonal block of H (before the gauge and damping)."""
    return _node_sums(plan, torch.matmul(Li, Ji), torch.matmul(Lj, Jj))


@dataclasses.dataclass(frozen=True)
class PoseGraphCGParams:
    max_iterations: int = 10
    cg_iterations: int = 50
    damping: float = 1e-4
    gauge_weight: float = 1e6
    cg_tol: float = 1e-8


def _shard(edges: PoseGraphEdges, axis: MeshAxis) -> PoseGraphEdges:
    """This rank's contiguous share of the edges (the JAX package's
    P(axis) split); the edge count must divide evenly."""
    E = edges.i.shape[0]
    if E % axis.size != 0:
        raise ValueError(f"edge count {E} not divisible by mesh axis size {axis.size}; pad "
                         "with valid=False edges")
    m = E // axis.size
    s = slice(axis.rank * m, (axis.rank + 1) * m)
    return PoseGraphEdges(edges.i[s], edges.j[s], Pose(edges.z.R[s], edges.z.t[s]),
                          edges.information[s], edges.valid[s])


def optimize_pose_graph_cg(poses: Pose, edges: PoseGraphEdges,
                           params: PoseGraphCGParams = PoseGraphCGParams(),
                           mesh=None, axis: str = "data"):
    """Matrix-free Gauss-Newton for graphs too large for the dense system:
    H δ = -g by block-Jacobi preconditioned CG, H·v edge by edge, so memory
    is O(N + E). With a ``mesh`` every rank passes the whole edge list,
    keeps its share of the ``axis`` and sums every edge-wise term over the
    axis. Returns (poses, chi² at the returned poses)."""
    ax = mesh.axis(axis) if mesh is not None else None
    if ax is not None:
        edges = _shard(edges, ax)
    n = poses.t.shape[0]
    plan = _plan(edges, n)
    eye6 = torch.eye(6, dtype=_F64, device=poses.t.device)

    def gn_step(poses):
        r, Ji, Jj, Li, Lj = _edge_terms(poses, edges)
        g = _node_sums(plan, torch.matmul(Li, r[..., None])[..., 0],
                       torch.matmul(Lj, r[..., None])[..., 0])
        D = _block_diag_sums(plan, Ji, Jj, Li, Lj)
        g, D = all_reduce_sum(g, ax), all_reduce_sum(D, ax)
        D[0] += params.gauge_weight * eye6
        Minv = torch.linalg.inv(D + params.damping * eye6)

        def A(v):
            hv = all_reduce_sum(_hvp(plan, edges, Ji, Jj, Li, Lj, v), ax)
            hv = hv + torch.cat([params.gauge_weight * v[:1], torch.zeros_like(v[1:])])
            return hv + params.damping * v

        def precond(v):
            return torch.matmul(Minv, v[..., None])[..., 0]

        b = -g
        x = torch.zeros_like(b)
        res = b - A(x)
        z = precond(res)
        p = z
        rz = torch.sum(res * z)
        for _ in range(params.cg_iterations):
            Ap = A(p)
            alpha = rz / torch.clamp(torch.sum(p * Ap), min=1e-30)
            x2 = x + alpha * p
            r2 = res - alpha * Ap
            z2 = precond(r2)
            rz2 = torch.sum(r2 * z2)
            p2 = z2 + rz2 / torch.clamp(rz, min=1e-30) * p
            # frozen once converged: the same trip count, masked updates
            live = rz >= params.cg_tol
            x, res, p, rz = (torch.where(live, a, b_) for a, b_ in
                             ((x2, x), (r2, res), (p2, p), (rz2, rz)))
        return _update(poses, x)

    for _ in range(params.max_iterations):
        poses = gn_step(poses)
    return poses, all_reduce_sum(_chi2(_edge_terms(poses, edges)[0], edges), ax)


def optimize_pose_graph_sharded(poses: Pose, edges: PoseGraphEdges, mesh,
                                params: PoseGraphParams = PoseGraphParams(),
                                axis: str = "data"):
    """Dense Gauss-Newton with the edges split over a mesh axis: every rank
    passes the whole edge list, assembles the partial (H, g, chi²) of its
    share, the partials are summed over the axis (in rank order) and the
    gauge prior is added once after the sum; every rank then solves the
    same system. The edge count must divide evenly (pad with valid=False
    edges). Returns (poses, chi² at the returned poses)."""
    ax = mesh.axis(axis)
    edges = _shard(edges, ax)
    plan = _plan(edges, poses.t.shape[0], dense=True)
    for _ in range(params.max_iterations):
        poses, _ = _dense_step(poses, edges, plan, params.damping, params.gauge_weight, ax)
    return poses, all_reduce_sum(_chi2(_edge_terms(poses, edges)[0], edges), ax)


def chi2_of(poses: Pose, edges: PoseGraphEdges, mesh=None, axis: str = "data") -> torch.Tensor:
    """chi² of the edges at ``poses`` (summed over the axis with a mesh)."""
    ax = mesh.axis(axis) if mesh is not None else None
    if ax is not None:
        edges = _shard(edges, ax)
    return all_reduce_sum(_chi2(_edge_terms(poses, edges)[0], edges), ax)
