"""The ICP loop's termination test of one iteration.

Reference: ICP.cpp:191-229 (the step-size and oscillation stall) and the
loop's checks of the pairings and the solver's pose. From the iteration's
pairings, the pose it started from (``pose``), the one before
(``prev_pose``) and the solver's (``new_pose``): the flags ``[no_pairs,
solver_ok, stalled]`` and the pose the loop keeps, the solver's unless it
is not finite or there were no pairs.

Two versions of one test. ``terminate_plain`` is PyTorch: the count of
``Pairings.size()``, two ``isfinite`` checks, two ``se3.delta_norms`` and
the stall comparisons, some 264 small kernels on the card; the CPU's path
and the card's for poses that are not float32. ``terminate_fused``
launches ``csrc/icp_terminate.cu`` once, which computes the same flags and
pose, the norms in ``core/se3.py``'s float32 operation order as PyTorch
runs it on the card; under ``torch.func.vmap`` it is one launch for the
whole batch. ``takes_kernel`` is the rule between them: it reads only the
tensors' device and type. ``terminate`` applies it.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pairings import BLOCK_TYPES, Pairings
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.ops import cuda_build
from mp2p_icp_tpu_torch.utils import profiler


def takes_kernel(pairings: Pairings, pose: Pose, prev_pose: Pose, new_pose: Pose) -> bool:
    """Whether the test takes the kernel (``terminate_fused``): the three
    poses and the live blocks' weights lie on the card, in float32."""
    tensors = [*pose, *prev_pose, *new_pose] + [getattr(pairings, name).weight
                                                for name in pairings.live]
    return all(x.device.type == "cuda" and x.dtype == torch.float32 for x in tensors)


def terminate(pairings: Pairings, pose: Pose, prev_pose: Pose, new_pose: Pose,
              eps_t: float, eps_r: float) -> Tuple[Pose, torch.Tensor]:
    """(the kept pose, flags [no_pairs, solver_ok, stalled] as a bool [3]),
    by the kernel where ``takes_kernel`` holds, else by the plain path. A
    trace's ``icp.terminate`` counter records the path of each test:
    ("fused", problems) at a launch, ("plain", None) otherwise (vmap hides
    the problems)."""
    if takes_kernel(pairings, pose, prev_pose, new_pose):
        pose_out, flags, _ = terminate_fused(pairings, pose, prev_pose, new_pose, eps_t, eps_r)
        return pose_out, flags
    profiler.count("icp.terminate", "plain", None)
    return terminate_plain(pairings, pose, prev_pose, new_pose, eps_t, eps_r)


def terminate_plain(pairings: Pairings, pose: Pose, prev_pose: Pose, new_pose: Pose,
                    eps_t: float, eps_r: float) -> Tuple[Pose, torch.Tensor]:
    """The test in PyTorch, on the device of its inputs."""
    no_pairs = pairings.size() == 0
    solver_ok = torch.isfinite(new_pose.t).all() & torch.isfinite(new_pose.R).all()
    # step-size + oscillation termination (ICP.cpp:191-229)
    dt1, dr1 = se3.delta_norms(pose, new_pose)
    dt2, dr2 = se3.delta_norms(prev_pose, new_pose)
    stalled = ((dt1 < eps_t) & (dr1 < eps_r)) | ((dt2 < eps_t) & (dr2 < eps_r))
    keep_new = solver_ok & ~no_pairs
    pose_out = Pose(torch.where(keep_new, new_pose.R, pose.R),
                    torch.where(keep_new, new_pose.t, pose.t))
    return pose_out, torch.stack([no_pairs, solver_ok, stalled])


def terminate_fused(pairings: Pairings, pose: Pose, prev_pose: Pose, new_pose: Pose,
                    eps_t: float, eps_r: float) -> Tuple[Pose, torch.Tensor, torch.Tensor]:
    """``terminate_plain`` in one launch of ``csrc/icp_terminate.cu``; also
    returns the step norms [dt1, dr1, dt2, dr2] (float32 [4]) of
    ``delta_norms(pose, new_pose)`` and ``delta_norms(prev_pose,
    new_pose)``. CUDA float32 tensors only (raises otherwise); no host
    read, nothing copied to the card. ``terminate_fused.launches`` counts
    the launches."""
    weights = [getattr(pairings, name).weight if name in pairings.live else None
               for name in BLOCK_TYPES]
    R, t, flags, norms = _terminate_op(*pose, *prev_pose, *new_pose, *weights,
                                       float(eps_t), float(eps_r))
    return Pose(R, t), flags, norms


terminate_fused.launches = 0

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the op's tensor arguments in order, each with the shape of one problem's
# (n: the rows of its block)
_TENSORS = (("R", (3, 3)), ("t", (3,)), ("prev_R", (3, 3)), ("prev_t", (3,)),
            ("new_R", (3, 3)), ("new_t", (3,))) + tuple((f"{name}_weight", ("n",))
                                                         for name in BLOCK_TYPES)


def _launch(B: int, args, eps_t: float, eps_r: float, out_R, out_t, out_flags,
            out_norms) -> None:
    """One launch for B problems. ``args``: the op's eleven tensors in
    order, each (tensor, batched), a weight None where its block is not
    live: a batched tensor has a leading B, an unbatched one is shared by
    every problem (stride 0). Checks every tensor, raises where the kernel
    does not take it."""
    dev = args[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"terminate_fused runs on the card, not on {dev}: the plain "
                         "path is terminate_plain")
    flat = []
    for (name, tail), a in zip(_TENSORS, args):
        if a is None:
            flat += [None, 0, 0]
            continue
        x, batched = a
        rows = x.shape[-1] if tail == ("n",) else None
        want = ((B,) if batched else ()) + (tail if rows is None else (rows,))
        if (x.dtype != torch.float32 or x.device != dev or tuple(x.shape) != want
                or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {want} on {dev}, got "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        flat += [x.data_ptr(), x.stride(0) if batched else 0]
        if rows is not None:
            flat.append(rows)
    fn = cuda_build.entry_point("icp_terminate", "mp2p_icp_terminate_f32", (
        _P, _L, _P, _L, _P, _L, _P, _L, _P, _L, _P, _L,
        _P, _L, _I, _P, _L, _I, _P, _L, _I, _P, _L, _I, _P, _L, _I,
        _I, _F, _F, _P, _P, _P, _P, _P))
    with torch.cuda.device(dev):
        err = fn(*flat, B, eps_t, eps_r, out_R.data_ptr(), out_t.data_ptr(),
                 out_flags.data_ptr(), out_norms.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"icp_terminate kernel launch failed: CUDA error {err}")
    terminate_fused.launches += 1
    profiler.count("icp.terminate", "fused", B)


def _outputs(shape, device):
    return (torch.empty(shape + (3, 3), dtype=torch.float32, device=device),
            torch.empty(shape + (3,), dtype=torch.float32, device=device),
            torch.empty(shape + (3,), dtype=torch.bool, device=device),
            torch.empty(shape + (4,), dtype=torch.float32, device=device))


@torch.library.custom_op("mp2p_icp_tpu_torch::icp_terminate", mutates_args=())
def _terminate_op(R: torch.Tensor, t: torch.Tensor, prev_R: torch.Tensor,
                  prev_t: torch.Tensor, new_R: torch.Tensor, new_t: torch.Tensor,
                  w_pt2pt: Optional[torch.Tensor], w_pt2ln: Optional[torch.Tensor],
                  w_pt2pl: Optional[torch.Tensor], w_ln2ln: Optional[torch.Tensor],
                  w_pl2pl: Optional[torch.Tensor], eps_t: float, eps_r: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    tensors = (R, t, prev_R, prev_t, new_R, new_t, w_pt2pt, w_pt2ln, w_pt2pl, w_ln2ln,
               w_pl2pl)
    out = _outputs((), R.device)
    _launch(1, [None if x is None else (x.contiguous(), False) for x in tensors], eps_t,
            eps_r, *out)
    return out


@_terminate_op.register_vmap
def _terminate_op_vmap(info, in_dims, *args):
    """Under torch.func.vmap: one launch for the batch, one block per
    problem. An unbatched input is shared by every problem (stride 0, not
    copied)."""
    tensors, (eps_t, eps_r) = args[:11], args[11:]
    out = _outputs((info.batch_size,), args[0].device)
    _launch(info.batch_size,
            [None if x is None else
             (x.contiguous(), False) if d is None else (x.movedim(d, 0).contiguous(), True)
             for x, d in zip(tensors, in_dims[:11])], eps_t, eps_r, *out)
    return out, (0, 0, 0, 0)
