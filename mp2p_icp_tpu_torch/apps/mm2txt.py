"""mm2txt: export a metric map's point layers to one TXT file each.

Port of ``mp2p_icp_tpu/apps/mm2txt.py`` (reference: apps/mm2txt/main.cpp:118):
``<map name>_<layer>.txt`` in the working directory, the columns x y z
then intensity, ring, time where the layer has them, each ``%.6f``.

Usage:
  python -m mp2p_icp_tpu_torch.apps.mm2txt map.mm.npz [-l LAYER ...] [--device cpu]
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mm2txt")
    ap.add_argument("input", help=".mm.npz metric map")
    ap.add_argument("-l", "--layer", action="append", default=None,
                    help="layer(s) to export (default: all)")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
    from mp2p_icp_tpu_torch.io.mm import load_mm_file, to_numpy

    with on_device(args.device) as device:
        mm = load_mm_file(args.input, device=device)
    base = pathlib.Path(args.input).name.replace(".mm.npz", "").replace(".npz", "")
    for name in args.layer or list(mm.layers):
        layer = mm.layers.get(name)
        if not isinstance(layer, PointCloud):
            print(f"skipping non-point layer '{name}'")
            continue
        n = int(layer.count)
        cols = [layer.to_numpy()]
        for ch in ("intensity", "ring", "time"):
            v = getattr(layer, ch)
            if v is not None:
                cols.append(to_numpy(v[:n]).reshape(-1, 1))
        out = f"{base}_{name}.txt"
        np.savetxt(out, np.hstack(cols), fmt="%.6f")
        print(f"wrote {out} ({n} points)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
