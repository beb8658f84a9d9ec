"""Gauss-Newton SE(3) optimiser over all five pairing types.

Port of ``mp2p_icp_tpu/solvers/gauss_newton.py`` (reference:
optimal_tf_gauss_newton.cpp:36-372): relinearised GN steps accumulating
H (6x6) and g from every pairing block, optional robust re-weighting and an
optional SE(3) prior, H delta = -g solved with Jacobi equilibration and one
step of iterative refinement, manifold update T <- T exp(delta).

The inner iterations run a fixed count on the device, as the JAX
``fori_loop`` does: once converged, a step keeps the pose unchanged, so the
loop needs no host sync.

Two versions of one solve. ``optimal_tf_gauss_newton`` is the plain one:
PyTorch over all five blocks (in float64 under ``solver.solve_in_f64``),
the CPU's path and the card's for every solve the kernel does not take.
``gn_solve_fused`` launches ``csrc/gn_solve.cu`` once for all inner
iterations of the live pt2pt and pt2pl blocks, summing in float64 in one
fixed order and rounding the pose to float32 once; under ``torch.func.vmap``
it is one launch for the whole batch, each problem summed as alone.
``takes_kernel`` is the rule between them: it reads only what the solve
is handed.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pairings import Pairings
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.ops import cuda_build
from mp2p_icp_tpu_torch.solvers import error_terms
from mp2p_icp_tpu_torch.solvers.common import PairWeights
from mp2p_icp_tpu_torch.solvers.robust import RobustKernel, robust_sqrt_weight
from mp2p_icp_tpu_torch.utils import profiler


@dataclasses.dataclass(frozen=True)
class GNParams:
    """Reference: OptimalTF_GN_Parameters (optimal_tf_gauss_newton.h)."""

    max_iterations: int = 3
    min_delta: float = 1e-7
    max_cost: float = 0.0  # stop once sqrt(total weighted errSq) <= this
    kernel: RobustKernel = RobustKernel.NONE
    kernel_param: object = 1.0  # float | Expression over ICP_ITERATION
    pair_weights: PairWeights = dataclasses.field(default_factory=PairWeights)
    damping: float = 1e-9  # Tikhonov damping for rank-deficient pairings


@dataclasses.dataclass(frozen=True)
class SE3Prior:
    """Gaussian prior on the pose: mean + 6x6 information matrix."""

    mean: Pose
    inv_cov: torch.Tensor  # [6, 6]


def _robust_w(base_w, r_sq, kernel, kernel_param):
    if kernel == RobustKernel.NONE:
        return base_w
    return base_w * robust_sqrt_weight(kernel, r_sq, kernel_param)


def _accumulate(H, g, e, r, J, w_pairs, kernel, kernel_param):
    """Add one block's weighted contributions (general Jacobian path).
    r: [C, D], J: [C, D, 6], w_pairs: [C] (0 => masked out)."""
    r_sq = torch.sum(r * r, dim=-1)
    w = _robust_w(w_pairs, r_sq, kernel, kernel_param)
    g = g + torch.einsum("c,cdk,cd->k", w, J, r)
    H = H + torch.einsum("c,cdk,cdl->kl", w, J, J)
    return H, g, e + torch.sum(w * r_sq)


def _pt2pt_closed_form(pose: Pose, local, globl, w):
    """Closed-form (H, g, errSq) for point-to-point pairs. With
    J = [R | -R hat(l)]:
      g = [ R^T s_r ;  sum w l x (R^T r) ]
      H = [[ (sum w) I , -hat(sum w l) ], [ hat(sum w l), (sum w |l|^2) I - sum w l l^T ]]
    """
    r = se3.apply(pose, local) - globl  # [C, 3]
    rtR = r @ pose.R  # R^T r per pair
    s_l = torch.einsum("c,ci->i", w, local)
    M = torch.einsum("c,ci,cj->ij", w, local, local)
    l_sq = torch.einsum("c,ci,ci->", w, local, local)
    eye = torch.eye(3, dtype=local.dtype, device=local.device)
    # assembled out of place (no writes into a fresh tensor), so the
    # function runs under torch.func.vmap
    H = torch.cat([
        torch.cat([torch.sum(w) * eye, -se3.hat(s_l)], dim=1),
        torch.cat([se3.hat(s_l), l_sq * eye - M], dim=1),
    ])
    g = torch.cat([
        torch.einsum("c,ci->i", w, rtR),
        torch.einsum("c,ci->i", w, torch.linalg.cross(local, rtR)),
    ])
    return H, g, torch.einsum("c,ci,ci->", w, r, r)


def gn_build_normal_equations(
    pose: Pose,
    pairings: Pairings,
    params: GNParams,
    prior: Optional[SE3Prior] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One linearisation: (H [6,6], g [6], total weighted squared error).
    pt2pt / pt2pl / pt2ln use closed-form block reductions; ln2ln / pl2pl
    go through the general Jacobian path (error_terms)."""
    pw = params.pair_weights
    kern, kp = params.kernel, params.kernel_param

    # ---- pt2pt (robust kernel applied through a pre-pass r_sq)
    p = pairings.pt2pt
    w_pt = p.weight * pw.pt2pt
    if kern != RobustKernel.NONE:
        r_sq0 = torch.sum(torch.square(se3.apply(pose, p.local) - p.globl), dim=-1)
        w_pt = _robust_w(w_pt, r_sq0, kern, kp)
    H, g, e = _pt2pt_closed_form(pose, p.local, p.globl, w_pt)

    # ---- pt2pl: J^T J = w u u^T with u = [R^T n ; l x R^T n], scalar
    # residual e_c = n . (T(l) - c)
    s = pairings.pt2pl
    e_c = torch.sum(s.plane_normal * (se3.apply(pose, s.local) - s.plane_centroid), dim=-1)
    w_pl = _robust_w(s.weight * pw.pt2pl, e_c * e_c, kern, kp)
    a = s.plane_normal @ pose.R  # R^T n
    u = torch.cat([a, torch.linalg.cross(s.local, a)], dim=-1)  # [C, 6]
    H = H + torch.einsum("c,ci,cj->ij", w_pl, u, u)
    g = g + torch.einsum("c,c,ci->i", w_pl, e_c, u)
    e = e + torch.einsum("c,c,c->", w_pl, e_c, e_c)

    # ---- pt2ln: H = H_pt2pt_form - sum w v v^T (v = [R^T d ; l x R^T d]),
    # g from the projected residual
    t = pairings.pt2ln
    diff = se3.apply(pose, t.local) - t.line_point
    r_ln = diff - t.line_dir * torch.sum(t.line_dir * diff, dim=-1, keepdim=True)
    w_ln = _robust_w(t.weight * pw.pt2ln, torch.sum(r_ln * r_ln, dim=-1), kern, kp)
    Hl, _, _ = _pt2pt_closed_form(pose, t.local, t.line_point, w_ln)
    b = t.line_dir @ pose.R  # R^T d
    v = torch.cat([b, torch.linalg.cross(t.local, b)], dim=-1)
    H = H + Hl - torch.einsum("c,ci,cj->ij", w_ln, v, v)
    rtR_ln = r_ln @ pose.R
    g = g + torch.cat([
        torch.einsum("c,ci->i", w_ln, rtR_ln),
        torch.einsum("c,ci->i", w_ln, torch.linalg.cross(t.local, rtR_ln)),
    ])
    e = e + torch.einsum("c,ci,ci->", w_ln, r_ln, r_ln)

    ll = pairings.ln2ln
    r, J = error_terms.error_line2line(
        pose, ll.local_point, ll.local_dir, ll.global_point, ll.global_dir
    )
    H, g, e = _accumulate(H, g, e, r, J, ll.weight * pw.ln2ln, kern, kp)

    pp = pairings.pl2pl
    r, J = error_terms.error_plane2plane(pose, pp.local_normal, pp.global_normal)
    H, g, e = _accumulate(H, g, e, r, J, pp.weight * pw.pl2pl, kern, kp)

    if prior is not None:
        # residual log(prior_mean^-1 ∘ pose); its Jacobian w.r.t. a right
        # perturbation is the inverse right Jacobian of SE(3) at the residual
        r0 = se3.log(se3.compose(se3.inverse(prior.mean), pose))
        Jp = se3.se3_right_jacobian_inv(r0)
        H = H + Jp.T @ prior.inv_cov @ Jp
        g = g + Jp.T @ (prior.inv_cov @ r0)
        e = e + r0 @ prior.inv_cov @ r0
    return H, g, e


def solve_normal_equations(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """f32 solve of H x = g for SPD H (6x6): Jacobi equilibration D H D, a
    Cholesky solve and one step of iterative refinement. A failed
    factorisation gives NaN (as JAX's Cholesky does), without a host sync."""
    d = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-30))
    Hs = H * d[:, None] * d[None, :]
    gs = g * d
    L, info = torch.linalg.cholesky_ex(Hs)
    L = torch.where(info == 0, L, torch.nan)
    y = torch.cholesky_solve(gs[:, None], L)[:, 0]
    r = gs - Hs @ y
    y = y + torch.cholesky_solve(r[:, None], L)[:, 0]
    return y * d


def optimal_tf_gauss_newton(
    pairings: Pairings,
    linearization_point: Pose,
    params: Optional[GNParams] = None,
    prior: Optional[SE3Prior] = None,
) -> Pose:
    """Iterated GN from a linearisation point."""
    params = params or GNParams()
    pose = linearization_point
    done = torch.zeros((), dtype=torch.bool, device=pose.t.device)
    eye6 = torch.eye(6, dtype=pose.t.dtype, device=pose.t.device)
    for _ in range(params.max_iterations):
        H, g, err_sq = gn_build_normal_equations(pose, pairings, params, prior)
        delta = -solve_normal_equations(H + params.damping * eye6, g)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        new_pose = se3.compose(pose, se3.exp(delta))
        # convergence tests (reference :344-346, :365-366)
        reached_cost = torch.sqrt(err_sq) <= params.max_cost
        small = torch.linalg.vector_norm(delta) < params.min_delta
        keep = torch.where(done | reached_cost, 0.0, 1.0)
        pose = Pose(
            R=pose.R * (1 - keep) + new_pose.R * keep,
            t=pose.t * (1 - keep) + new_pose.t * keep,
        )
        done = done | reached_cost | small
    return pose


# ------------------------------------------------- the solve as one kernel
FUSED_BLOCKS = frozenset({"pt2pt", "pt2pl"})


def takes_kernel(live: frozenset, device: torch.device, kernel: RobustKernel,
                 prior: Optional[SE3Prior]) -> bool:
    """Whether a Gauss-Newton solve takes the kernel (``gn_solve_fused``):
    its tensors lie on the card, only pt2pt and pt2pl blocks are live
    (``Pairings.live``), no robust kernel and no prior. Every other solve
    runs the plain path."""
    return (device.type == "cuda" and live <= FUSED_BLOCKS
            and kernel == RobustKernel.NONE and prior is None)


def gn_solve_fused(pairings: Pairings, guess: Pose, params: GNParams) -> Pose:
    """``solve_in_f64(optimal_tf_gauss_newton)`` of the live pt2pt and pt2pl
    blocks in one launch of ``csrc/gn_solve.cu``: every inner iteration on
    the card, the pose rounded to the guess's float32 once. CUDA tensors
    only (raises otherwise); no host read, nothing copied to the card.
    ``gn_solve_fused.launches`` counts the launches."""
    pt = (pairings.pt2pt.local, pairings.pt2pt.globl, pairings.pt2pt.weight)
    pl = (pairings.pt2pl.local, pairings.pt2pl.plane_centroid,
          pairings.pt2pl.plane_normal, pairings.pt2pl.weight)
    pw = params.pair_weights
    R, t = _gn_op(*(pt if "pt2pt" in pairings.live else (None,) * 3),
                  *(pl if "pt2pl" in pairings.live else (None,) * 4),
                  guess.R, guess.t, params.max_iterations, float(params.min_delta),
                  float(params.max_cost), float(params.damping), float(pw.pt2pt),
                  float(pw.pt2pl))
    return Pose(R, t)


gn_solve_fused.launches = 0

_P, _I, _L, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double
# the op's tensor arguments in order, each with the shape of one problem's
# (n: the rows of its block)
_TENSORS = (("pt_local", ("n", 3)), ("pt_global", ("n", 3)), ("pt_weight", ("n",)),
            ("pl_local", ("n", 3)), ("pl_centroid", ("n", 3)), ("pl_normal", ("n", 3)),
            ("pl_weight", ("n",)), ("R", (3, 3)), ("t", (3,)))


def _launch(B: int, args, iterations: int, min_delta: float, max_cost: float,
            damping: float, w_pt: float, w_pl: float, out_R, out_t) -> None:
    """One launch for B problems. ``args``: the op's nine tensors in order,
    each None (a block that is not live: all of its tensors) or (tensor,
    batched): a batched tensor has a leading B, an unbatched one is shared
    by every problem (stride 0). Checks every tensor, raises where the
    kernel does not take it."""
    n_pt = 0 if args[2] is None else args[2][0].shape[-1]
    n_pl = 0 if args[6] is None else args[6][0].shape[-1]
    if (args[0] is None) != (args[2] is None) or len({a is None for a in args[3:7]}) > 1:
        raise ValueError("a block's tensors are all given or all None")
    dev = args[7][0].device
    if dev.type != "cuda":
        raise ValueError(f"gn_solve_fused runs on the card, not on {dev}: the plain "
                         "path is optimal_tf_gauss_newton")
    rows = {"pt": n_pt, "pl": n_pl}
    flat = []
    for (name, tail), a in zip(_TENSORS, args):
        if a is None:
            flat += [None, 0]
            continue
        x, batched = a
        want = ((B,) if batched else ()) + tuple(rows[name[:2]] if d == "n" else d
                                                 for d in tail)
        if (x.dtype != torch.float32 or x.device != dev or tuple(x.shape) != want
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {want} on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        flat += [x.data_ptr(), x.stride(0) if batched else 0]
    fn = cuda_build.entry_point("gn_solve", "mp2p_gn_solve_f32", (
        _P, _L, _P, _L, _P, _L, _I, _P, _L, _P, _L, _P, _L, _P, _L, _I, _P, _L, _P, _L,
        _I, _I, _D, _D, _D, _D, _D, _P, _P, _P))
    with torch.cuda.device(dev):
        err = fn(*flat[:6], n_pt, *flat[6:14], n_pl, *flat[14:], B, iterations, min_delta,
                 max_cost, damping, w_pt, w_pl, out_R.data_ptr(), out_t.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_solve kernel launch failed: CUDA error {err}")
    gn_solve_fused.launches += 1
    profiler.count("gn.solve", "fused", B, n_pt + n_pl)


@torch.library.custom_op("mp2p_icp_tpu_torch::gn_solve", mutates_args=())
def _gn_op(pt_local: Optional[torch.Tensor], pt_global: Optional[torch.Tensor],
           pt_weight: Optional[torch.Tensor], pl_local: Optional[torch.Tensor],
           pl_centroid: Optional[torch.Tensor], pl_normal: Optional[torch.Tensor],
           pl_weight: Optional[torch.Tensor], R: torch.Tensor, t: torch.Tensor,
           iterations: int, min_delta: float, max_cost: float, damping: float, w_pt: float,
           w_pl: float) -> Tuple[torch.Tensor, torch.Tensor]:
    tensors = (pt_local, pt_global, pt_weight, pl_local, pl_centroid, pl_normal, pl_weight,
               R, t)
    out_R = torch.empty((3, 3), dtype=torch.float32, device=R.device)
    out_t = torch.empty(3, dtype=torch.float32, device=R.device)
    _launch(1, [None if x is None else (x.contiguous(), False) for x in tensors], iterations,
            min_delta, max_cost, damping, w_pt, w_pl, out_R, out_t)
    return out_R, out_t


@_gn_op.register_vmap
def _gn_op_vmap(info, in_dims, *args):
    """Under torch.func.vmap: one launch for the batch, one block per
    problem, each summed in the order of a single solve. An unbatched input
    is shared by every problem (stride 0, not copied)."""
    tensors, scalars = args[:9], args[9:]
    B = info.batch_size
    out_R = torch.empty((B, 3, 3), dtype=torch.float32, device=args[7].device)
    out_t = torch.empty((B, 3), dtype=torch.float32, device=args[7].device)
    _launch(B, [None if x is None else
                (x.contiguous(), False) if d is None else (x.movedim(d, 0).contiguous(), True)
                for x, d in zip(tensors, in_dims[:9])], *scalars, out_R, out_t)
    return (out_R, out_t), (0, 0)
