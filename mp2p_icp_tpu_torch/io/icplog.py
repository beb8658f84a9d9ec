"""ICP run log records (.icplog.npz).

Port of ``mp2p_icp_tpu/io/icplog.py`` (reference: LogRecord.h:38-102): one
ICP run as a compressed npz: both maps' point layers, the guess, the
result pose, covariance, quality and termination, and, when the align
recorded them, the per-iteration poses, pair counts and decimated pairings.
The keys are the JAX package's, so either package loads the other's files.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from mp2p_icp_tpu_torch.core import pairings as _pairings
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.core.se3 import Pose
from mp2p_icp_tpu_torch.device import resolve
from mp2p_icp_tpu_torch.matchers.base import point_layers


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_log(path, local_mm, global_mm, guess, results) -> None:
    """Write one run. Only the maps' point layers are stored (a voxel
    layer in a dict map has no points to store)."""
    meta = {
        "version": 1,
        "n_iterations": int(results.n_iterations),
        "termination_reason": int(results.termination_reason),
        "quality": float(results.quality),
        "n_pairings": int(results.final_pairings.size()),
    }
    arrays = {
        "guess/R": _np(guess.R), "guess/t": _np(guess.t),
        "result/R": _np(results.optimal_tf.R), "result/t": _np(results.optimal_tf.t),
        "result/cov": _np(results.covariance),
    }
    if results.iteration_poses is not None:
        arrays["iters/R"] = _np(results.iteration_poses.R)
        arrays["iters/t"] = _np(results.iteration_poses.t)
        arrays["iters/pair_counts"] = _np(results.iteration_pair_counts)
    ip = results.iteration_pairings
    if ip is not None:
        for block_name in _pairings.BLOCK_TYPES:
            block = getattr(ip, block_name)
            for f in dataclasses.fields(block):
                arrays[f"iters/pairings/{block_name}/{f.name}"] = _np(getattr(block, f.name))
    for prefix, mm in (("local", local_mm), ("global", global_mm)):
        for name, pc in point_layers(mm).items():
            if isinstance(pc, PointCloud):
                arrays[f"{prefix}/{name}/xyz"] = _np(pc.xyz)
                arrays[f"{prefix}/{name}/count"] = _np(pc.count)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_log(path, device=None) -> dict:
    """A run written by ``save_log`` (of either package): {"meta", "guess",
    "result", "covariance", "local", "global"[, "iterations"]}, tensors on
    ``device`` (None: ``default_device()``)."""
    device = resolve(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    with np.load(path) as data:
        out = {
            "meta": json.loads(bytes(data["__meta__"]).decode()),
            "guess": Pose(t(data["guess/R"]), t(data["guess/t"])),
            "result": Pose(t(data["result/R"]), t(data["result/t"])),
            "covariance": t(data["result/cov"]),
            "local": {},
            "global": {},
        }
        if "iters/t" in data.files:
            out["iterations"] = {
                "poses": Pose(t(data["iters/R"]), t(data["iters/t"])),
                "pair_counts": t(data["iters/pair_counts"]),
            }
        if "iters/pairings/pt2pt/weight" in data.files:
            blocks = {
                name: cls(**{f.name: t(data[f"iters/pairings/{name}/{f.name}"])
                             for f in dataclasses.fields(cls)})
                for name, cls in _pairings.BLOCK_TYPES.items()
            }
            out["iterations"]["pairings"] = _pairings.Pairings(
                potential_pairings=torch.zeros((), dtype=torch.int32, device=device), **blocks)
        for key in data.files:
            for prefix in ("local", "global"):
                if key.startswith(prefix + "/") and key.endswith("/xyz"):
                    name = key.split("/")[1]
                    out[prefix][name] = PointCloud(
                        xyz=t(data[key]), count=t(data[f"{prefix}/{name}/count"]))
    return out
