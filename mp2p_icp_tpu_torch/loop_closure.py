"""Loop closure: revisit detection, ICP verification, pose-graph correction.

Port of ``mp2p_icp_tpu/loop_closure.py``:

1. ``propose_loop_candidates``: frame pairs far apart in time and close in
   space on the estimated trajectory (numpy, on the host);
2. ``close_loops``: each candidate re-registered scan to scan with
   ``ICP.align`` from the guess T_i^-1 T_j of the drifting odometry; low
   quality or a large correction rejects it;
3. ``optimize_trajectory``: the odometry edges and the accepted loop edges
   through the dense Gauss-Newton pose graph
   (``parallel/pose_graph.optimize_pose_graph``), the result re-anchored
   at the first pose.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.device import resolve
from mp2p_icp_tpu_torch.parallel.pose_graph import (
    PoseGraphEdges,
    PoseGraphParams,
    optimize_pose_graph,
)


def propose_loop_candidates(
    poses: np.ndarray,
    min_frame_gap: int = 10,
    max_distance: float = 3.0,
    stride: int = 1,
    max_candidates: int = 32,
) -> List[Tuple[int, int]]:
    """Revisit test: (i, j) with j - i >= min_frame_gap and
    |t_i - t_j| <= max_distance, greedily thinned so that no frame appears
    in more than one candidate (closest first)."""
    t = np.asarray(poses)[:, :3, 3]
    n = t.shape[0]
    cands = []
    for j in range(0, n, stride):
        for i in range(0, j - min_frame_gap, stride):
            d = float(np.linalg.norm(t[i] - t[j]))
            if d <= max_distance:
                cands.append((d, i, j))
    cands.sort()
    used = set()
    out = []
    for _d, i, j in cands:
        if i in used or j in used:
            continue
        out.append((i, j))
        used.update((i, j))
        if len(out) >= max_candidates:
            break
    return out


def _pose(mat: np.ndarray, device) -> Pose:
    return Pose(torch.as_tensor(np.asarray(mat[:3, :3], np.float32), device=device),
                torch.as_tensor(np.asarray(mat[:3, 3], np.float32), device=device))


def close_loops(
    icp,
    params,
    local_clouds: Sequence[PointCloud],
    poses: np.ndarray,
    candidates: Sequence[Tuple[int, int]],
    layer: str = "raw",
    min_quality: float = 0.5,
    max_correction: float = 5.0,
) -> List[Tuple[int, int, Pose, float]]:
    """Verify candidates by scan-to-scan registration: cloud j onto cloud i
    from the guess T_i^-1 T_j, on the clouds' device. Returns the accepted
    (i, j, Z_ij, quality) loop measurements."""
    accepted = []
    for i, j in candidates:
        cloud_i, cloud_j = local_clouds[i], local_clouds[j]
        dev = cloud_i.xyz.device
        guess = se3.compose(se3.inverse(_pose(poses[i], dev)), _pose(poses[j], dev))
        res = icp.align({layer: cloud_j}, {layer: cloud_i}, guess, params)
        q = float(res.quality)
        corr = float(torch.linalg.vector_norm(res.optimal_tf.t - guess.t))
        if q >= min_quality and corr <= max_correction:
            accepted.append((i, j, res.optimal_tf, q))
    return accepted


def optimize_trajectory(
    poses: np.ndarray,
    loops: Sequence[Tuple[int, int, Pose, float]],
    odom_information: float = 1.0,
    loop_information: float = 10.0,
    gn_params: Optional[PoseGraphParams] = None,
    device=None,
) -> np.ndarray:
    """Pose-graph Gauss-Newton over the odometry edges (consecutive
    estimated relative poses) and the accepted loop edges, on ``device``
    (default: the loops' device, else the package's default). Node 0 is
    held by the solver's gauge prior. Returns the corrected [N, 4, 4]
    trajectory."""
    n = poses.shape[0]
    if not loops:
        return np.asarray(poses)
    dev = loops[0][2].t.device if device is None else resolve(device)
    nodes = Pose(torch.as_tensor(np.asarray(poses[:, :3, :3], np.float32), device=dev),
                 torch.as_tensor(np.asarray(poses[:, :3, 3], np.float32), device=dev))
    odo = se3.compose(se3.inverse(Pose(nodes.R[:-1], nodes.t[:-1])),
                      Pose(nodes.R[1:], nodes.t[1:]))
    loop_R = torch.stack([z.R.to(dev) for _i, _j, z, _q in loops])
    loop_t = torch.stack([z.t.to(dev) for _i, _j, z, _q in loops])
    weights = [odom_information] * (n - 1) + [loop_information * q for _i, _j, _z, q in loops]
    edges = PoseGraphEdges(
        i=torch.as_tensor(list(range(n - 1)) + [i for i, _j, _z, _q in loops], device=dev),
        j=torch.as_tensor(list(range(1, n)) + [j for _i, j, _z, _q in loops], device=dev),
        z=Pose(torch.cat([odo.R, loop_R]), torch.cat([odo.t, loop_t])),
        information=torch.as_tensor(
            np.eye(6, dtype=np.float32)[None] * np.asarray(weights, np.float32)[:, None, None],
            device=dev),
        valid=torch.ones(n - 1 + len(loops), dtype=torch.bool, device=dev),
    )
    opt, _chi2 = optimize_pose_graph(nodes, edges, gn_params or PoseGraphParams(max_iterations=15))
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :3] = opt.R.cpu().numpy()
    out[:, :3, 3] = opt.t.cpu().numpy()
    # re-anchor at the original first pose (the gauge prior holds node 0
    # near its initial value; make it exact)
    fix = poses[0] @ np.linalg.inv(out[0])
    return np.einsum("ab,nbc->nac", fix, out)


def close_and_optimize(
    icp,
    params,
    local_clouds: Sequence[PointCloud],
    poses: np.ndarray,
    min_frame_gap: int = 10,
    max_distance: float = 3.0,
    layer: str = "raw",
    min_quality: float = 0.5,
) -> Dict:
    """Propose, verify, optimise. Returns {"poses", "n_candidates",
    "n_accepted", "loops": [(i, j, quality)]}."""
    cands = propose_loop_candidates(poses, min_frame_gap=min_frame_gap, max_distance=max_distance)
    loops = close_loops(icp, params, local_clouds, poses, cands, layer=layer,
                        min_quality=min_quality)
    return {
        "poses": optimize_trajectory(poses, loops),
        "n_candidates": len(cands),
        "n_accepted": len(loops),
        "loops": [(i, j, float(q)) for i, j, _z, q in loops],
    }
