"""sm-cli: the simple-map (keyframe map) toolbox.

Port of ``mp2p_icp_tpu/apps/sm_cli.py`` (reference: apps/sm-cli): info,
join, cut, tf, level, trim, export-kfs and export-rawlog on .sm.npz files.

Usage:
  python -m mp2p_icp_tpu_torch.apps.sm_cli [--device cpu] info map.sm.npz
  python -m mp2p_icp_tpu_torch.apps.sm_cli cut map.sm.npz --from-index 2 --to-index 9 -o cut.sm.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def _load(path):
    from mp2p_icp_tpu_torch.filters.sm2mm import SimpleMap

    return SimpleMap.load(path)


def _t(kf) -> np.ndarray:
    return kf.pose.t.cpu().numpy()


def cmd_info(args):
    sm = _load(args.input)
    n_obs = sum(len(kf.observations) for kf in sm.keyframes)
    n_pts = sum(o.xyz.shape[0] for kf in sm.keyframes for o in kf.observations
                if o.xyz is not None)
    print(f"keyframes: {len(sm.keyframes)}")
    print(f"observations: {n_obs}")
    print(f"total points: {n_pts}")
    if sm.keyframes:
        ts = np.stack([_t(kf) for kf in sm.keyframes])
        d = np.linalg.norm(np.diff(ts, axis=0), axis=1).sum()
        print(f"trajectory length: {d:.2f} m")
        print(f"bbox: {ts.min(0).round(2)} .. {ts.max(0).round(2)}")
    return 0


def cmd_join(args):
    from mp2p_icp_tpu_torch.filters.sm2mm import SimpleMap

    out = SimpleMap()
    for p in args.inputs:
        out.keyframes.extend(_load(p).keyframes)
    out.save(args.output)
    print(f"wrote {args.output}: {len(out.keyframes)} keyframes")
    return 0


def cmd_cut(args):
    sm = _load(args.input)
    sm.keyframes = sm.keyframes[args.from_index: args.to_index]
    sm.save(args.output)
    print(f"wrote {args.output}: {len(sm.keyframes)} keyframes")
    return 0


def cmd_tf(args):
    """Left-multiply every keyframe pose by a transform."""
    from mp2p_icp_tpu_torch.core import se3

    sm = _load(args.input)
    T = se3.from_xyz_ypr(*[float(x) for x in args.transform.split()])
    for kf in sm.keyframes:
        kf.pose = se3.compose(T, kf.pose)
    sm.save(args.output)
    print(f"wrote {args.output} (transformed {len(sm.keyframes)} keyframes)")
    return 0


def cmd_level(args):
    """Rotate so that the mean plane of the trajectory becomes horizontal
    (reference: sm-cli level)."""
    from mp2p_icp_tpu_torch.core import se3

    sm = _load(args.input)
    ts = np.stack([_t(kf) for kf in sm.keyframes])
    if len(ts) >= 3:
        _, _, vt = np.linalg.svd(ts - ts.mean(0))
        normal = vt[2] if vt[2][2] >= 0 else -vt[2]
        z = np.array([0.0, 0.0, 1.0])
        v = np.cross(normal, z)
        sv = np.linalg.norm(v)
        if sv > 1e-9:
            ang = np.arctan2(sv, normal @ z)
            dev = sm.keyframes[0].pose.t.device
            R = se3.so3_exp(torch.tensor(v / sv * ang, dtype=torch.float32, device=dev))
            T = se3.Pose(R, torch.zeros(3, device=dev))
            for kf in sm.keyframes:
                kf.pose = se3.compose(T, kf.pose)
    sm.save(args.output)
    print(f"wrote {args.output} (levelled)")
    return 0


def cmd_trim(args):
    """Keep only the keyframes whose position lies inside a box
    (reference: apps/sm-cli/sm-cli-trim.cpp:37-46)."""
    sm = _load(args.input)
    lo = np.array([float(x) for x in args.min_corner.split()])
    hi = np.array([float(x) for x in args.max_corner.split()])
    sm.keyframes = [kf for kf in sm.keyframes if np.all(_t(kf) >= lo) and np.all(_t(kf) <= hi)]
    sm.save(args.output)
    print(f"wrote {args.output}: {len(sm.keyframes)} keyframes (trimmed)")
    return 0


def cmd_export_kfs(args):
    """The keyframe poses in TUM format (i x y z qx qy qz qw)."""
    from mp2p_icp_tpu_torch.core import se3

    sm = _load(args.input)
    with open(args.output, "w") as f:
        for i, kf in enumerate(sm.keyframes):
            t = _t(kf)
            q = se3.rot_to_quat(kf.pose.R).cpu().numpy()  # wxyz
            f.write(f"{i} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")
    print(f"wrote {args.output}: {len(sm.keyframes)} poses (TUM format)")
    return 0


def cmd_export_rawlog(args):
    """The keyframes as a flat observation stream (.rawlog.npz)
    (reference: apps/sm-cli/sm-cli-export-rawlog.cpp:39-88): each keyframe
    is one sensory frame of its observations, a 'pose'
    CObservationRobotPose and, where the keyframe stores one, a 'twist'
    comment."""
    from mp2p_icp_tpu_torch.filters.generator import Observation
    from mp2p_icp_tpu_torch.io.rawlog import Rawlog

    sm = _load(args.input)
    rl = Rawlog()
    for i, kf in enumerate(sm.keyframes):
        ts = next((o.timestamp for o in kf.observations if o.timestamp), 0.0)
        for o in kf.observations:
            rl.append(o, frame=i)
        rl.append(Observation(class_name="CObservationRobotPose", sensor_label="pose",
                              timestamp=ts, sensor_pose=kf.pose), frame=i)
        if kf.twist is not None:
            rl.append(Observation(
                class_name="CObservationComment", sensor_label="twist", timestamp=ts,
                text="Twist stored in the simplemap keyframe:\n"
                     + " ".join(f"{v:.6g}" for v in kf.twist)), frame=i)
    rl.save(args.output)
    print(f"wrote {args.output}: {len(rl)} observations from {len(sm.keyframes)} keyframes")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sm-cli")
    add_device_argument(ap)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def command(name, fn, *arguments):
        p = sub.add_parser(name)
        for names, kw in arguments:
            p.add_argument(*names, **kw)
        p.set_defaults(fn=fn)

    out = (("-o", "--output"), dict(required=True))
    command("info", cmd_info, (("input",), {}))
    command("join", cmd_join, (("inputs",), dict(nargs="+")), out)
    command("cut", cmd_cut, (("input",), {}), (("--from-index",), dict(type=int, default=0)),
            (("--to-index",), dict(type=int, default=None)), out)
    command("tf", cmd_tf, (("input",), {}), (("-t", "--transform"), dict(
        required=True, help="'x y z yaw pitch roll' (radians)")), out)
    command("level", cmd_level, (("input",), {}), out)
    command("trim", cmd_trim, (("input",), {}),
            (("--min-corner",), dict(required=True, help="'xmin ymin zmin'")),
            (("--max-corner",), dict(required=True, help="'xmax ymax zmax'")), out)
    command("export-kfs", cmd_export_kfs, (("input",), {}), out)
    command("export-rawlog", cmd_export_rawlog, (("input",), {}), out)
    args = ap.parse_args(argv)
    with on_device(args.device):
        return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
