"""mm-viewer: inspect a metric map: text report, PNG renders, and a
standalone interactive WebGL HTML export.

Port of ``mp2p_icp_tpu/apps/mm_viewer.py`` (reference: apps/mm-viewer/main.cpp,
a nanogui/OpenGL inspector). ``--html`` writes a self-contained page
(apps/html_viewer.py): orbit camera, per-layer toggles, colour modes, voxel
occupancy, trajectory overlay. ``-o`` renders headless PNGs of the point
and voxel layers, with an optional trajectory overlay (KITTI 3x4 rows or
TUM 'ts x y z qx qy qz qw'); it needs matplotlib, which is imported only
there.

Usage:
  python -m mp2p_icp_tpu_torch.apps.mm_viewer map.mm.npz [--html out.html]
      [-o PREFIX] [-l LAYER ...] [--trajectory poses.txt] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mm-viewer")
    ap.add_argument("input", help=".mm / .mm.npz metric map")
    ap.add_argument("-o", "--output-prefix", default=None,
                    help="write <prefix>_<layer>.png renders")
    ap.add_argument("-l", "--layer", action="append", default=None)
    ap.add_argument("--html", default=None,
                    help="write a standalone interactive WebGL viewer (orbit/pan/zoom, "
                         "layer toggles, colour modes)")
    ap.add_argument("--trajectory", default=None,
                    help="overlay a trajectory polyline (KITTI 3x4-per-line or TUM "
                         "'ts x y z qx qy qz qw' text file) in the PNG/HTML renders")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from mp2p_icp_tpu_torch.io.mm import load_mm_file

    with on_device(args.device) as device:
        mm = load_mm_file(args.input, device=device)
    print(mm.contents_summary())

    traj = None
    if args.trajectory:
        raw = np.loadtxt(args.trajectory)
        raw = raw.reshape(raw.shape[0], -1)
        if raw.shape[1] == 12:  # KITTI 3x4
            traj = raw.reshape(-1, 3, 4)[:, :, 3]
        elif raw.shape[1] == 8:  # TUM ts x y z qx qy qz qw
            traj = raw[:, 1:4]
        else:
            raise SystemExit(f"unrecognised trajectory format ({raw.shape[1]} columns)")

    if args.html:
        from mp2p_icp_tpu_torch.apps.html_viewer import export_map_html

        export_map_html(mm, args.html, trajectory=traj)
        print(f"wrote {args.html}")

    if args.output_prefix:
        _render_png(mm, args.output_prefix, args.layer, traj)
    return 0


def _render_png(mm, prefix, layer_names, traj) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from mp2p_icp_tpu_torch.core.metric_map import VoxelGridLayer
    from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
    from mp2p_icp_tpu_torch.io.mm import to_numpy

    for name in layer_names or list(mm.layers):
        layer = mm.layers.get(name)
        if isinstance(layer, PointCloud):
            pts = layer.to_numpy()
            c = pts[:, 2] if len(pts) else None
            kind = "points"
        elif isinstance(layer, VoxelGridLayer):
            valid = to_numpy(layer.valid)
            pts = to_numpy(layer.centers())[valid]
            c = to_numpy(layer.occupancy)[valid]
            kind = "voxels (colour = occupancy)"
        else:
            continue
        if len(pts) == 0:
            continue
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, 6))
        ax1.scatter(pts[:, 0], pts[:, 1], s=1, c=c, cmap="viridis")
        ax1.set_title(f"{name} — top ({kind})")
        ax1.set_aspect("equal")
        ax2.scatter(pts[:, 0], pts[:, 2], s=1, c=c, cmap="viridis")
        ax2.set_title(f"{name} — side")
        if traj is not None:
            ax1.plot(traj[:, 0], traj[:, 1], "r-", lw=1)
            ax2.plot(traj[:, 0], traj[:, 2], "r-", lw=1)
        out = f"{prefix}_{name}.png"
        fig.savefig(out, dpi=110, bbox_inches="tight")
        plt.close(fig)
        print(f"wrote {out} ({len(pts)} points)")


if __name__ == "__main__":
    sys.exit(main())
