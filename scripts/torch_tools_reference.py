#!/usr/bin/env python3
"""The JAX package's results for the tools phase of chip_smoke.py, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/torch_tools_reference.py [--frames N]
        [--rings R --azimuths A] [--keyframes K] [--port] [--write FILE]

Renders chip_smoke.py's inputs from their seeds: the apps phase's street
drive at HDL-64E geometry (``chip_smoke.write_apps_sequence``' scans) as a
``.rawlog.npz`` (``chip_smoke.write_rawlog``), frame 0 as KITTI .bin, and the
sm2mm phase's pass-1 simple map (``chip_smoke.sm2mm_inputs``). It feeds
the same files to the JAX package's apps and prints one JSON object with
the constants chip_smoke.py holds the port against; ``--write`` also writes
it to a file, and chip_smoke.py reads ``scripts/torch_tools_reference.json``,
written so with the defaults:

- "rawlog": rawlog-filter with ``chip_smoke.TOOLS_YAML`` over the sequence:
  ``chip_smoke.rawlog_summary`` of its output (per frame, each entry's
  label, rows, coordinate and channel sums);
- "rawlog_normals": per frame, ``chip_smoke.normals_summary`` of the
  decimated layer that run fitted (rawlog-filter writes no normals; they
  are captured from its pipeline by ``chip_smoke.captured_layers``), and
  "rawlog_normal_rows": the normals of frames 0 and the last, row for row
  (``chip_smoke.pack_normals``);
- "sm_filter": sm-filter with the same YAML (output layer "decimated") on
  the simple map: the points of each keyframe, the printed line, and the
  normals' summary per keyframe;
- "georef": mm-georef's printed lines for ``chip_smoke.GEOREF`` (--inject,
  then the default print, --geodetic-to-map GEOREF_FIX, --map-to-geodetic
  GEOREF_POINT);
- "mm_info": mm-info's line for kitti2mm of frame 0.

One substitution keeps the JAX runs within reach of a CPU: the FirstPoint
decimation keeps the raw capacity of its input (131072 rows), and the
JAX package's normals fit sweeps all of it (2^34 pairs a frame, ~55 s on a
CPU). Here the JAX side's decimated capacity is the next power of two above
the largest 0.5 m voxel count of the sequence; the padding rows take part
in no neighbourhood, so no row changes. ``--port`` also runs the port's
apps on the CPU at their own capacities and prints their results in the
same form, with the differences: at a small size (``--frames 4 --rings 16
--azimuths 512 --keyframes 3``) that is the check that the substitution
moves nothing.

This script is not part of the port: it imports both packages. JAX runs on
the CPU (set JAX_PLATFORMS=cpu).
"""

import argparse
import contextlib
import io
import json
import pathlib
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import numpy as np  # noqa: E402
import yaml  # noqa: E402

import chip_smoke as cs  # noqa: E402
import mp2p_icp_tpu_torch  # noqa: E402
from mp2p_icp_tpu_torch.core.pointcloud import round_capacity  # noqa: E402
from torch_apps_reference import decimation_capacity  # noqa: E402


def printed(fn, argv):
    """What ``fn(argv)`` prints (its return code must be 0)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn([str(a) for a in argv]) == 0
    return buf.getvalue()


def largest_voxel_count(scans, resolution):
    """The most voxels of ``resolution`` the returns of any scan occupy."""
    return max(len(np.unique(np.floor(sc["xyz"][sc["valid"]] / np.float32(resolution)), axis=0))
               for sc in scans)


def packages(port):
    """(apps module getter, filters package, Rawlog, SimpleMap) of one package."""
    import importlib

    root = "mp2p_icp_tpu_torch" if port else "mp2p_icp_tpu"
    return (lambda name: importlib.import_module(f"{root}.apps.{name}"),
            importlib.import_module(f"{root}.filters"),
            importlib.import_module(f"{root}.io.rawlog").Rawlog,
            importlib.import_module(f"{root}.filters.sm2mm").SimpleMap)


def run_all(args, port, tmp, capacity):
    app, filters, Rawlog, SimpleMap = packages(port)
    who = "port" if port else "jax"
    out_dir = pathlib.Path(tmp) / who
    out_dir.mkdir()

    def trim():
        return contextlib.nullcontext() if port else decimation_capacity(capacity)

    res = {}
    t0 = time.perf_counter()
    record = []
    with trim(), cs.captured_layers(filters, record):
        printed(app("rawlog_filter").main, ["-i", pathlib.Path(tmp) / "in.rawlog.npz",
                                            "-o", out_dir / "out.rawlog.npz", "-p",
                                            pathlib.Path(tmp) / "tools.yaml", "-v", "QUIET"])
    res["rawlog"] = cs.rawlog_summary(Rawlog.load(str(out_dir / "out.rawlog.npz")))
    res["rawlog_normals"] = [cs.normals_summary(r) for r in record]
    res["rawlog_normal_rows"] = {str(i): cs.pack_normals(
        record[i]["normals"][: int(record[i]["count"])]) for i in (0, len(record) - 1)}
    res["rawlog_seconds"] = time.perf_counter() - t0
    print(f"[reference] {who} rawlog-filter: {res['rawlog_seconds']:.1f} s", file=sys.stderr,
          flush=True)

    t0 = time.perf_counter()
    record = []
    with trim(), cs.captured_layers(filters, record):
        line = printed(app("sm_filter").main, [
            "-i", pathlib.Path(tmp) / "in.sm.npz", "-o", out_dir / "out.sm.npz", "-p",
            pathlib.Path(tmp) / "tools.yaml", "--output-layer", cs.TOOLS_LAYER])
    res["sm_filter"] = {"points": cs.simplemap_summary(SimpleMap.load(str(out_dir / "out.sm.npz"))),
                        "line": line.replace(str(out_dir), "OUT"),
                        "normals": [cs.normals_summary(r) for r in record],
                        "seconds": time.perf_counter() - t0}
    return res, out_dir


def run_small_apps(port, tmp, out_dir):
    """kitti2mm + mm-info on frame 0, mm-georef's lines on that map."""
    app = packages(port)[0]
    res = {}
    mm = out_dir / "frame0.mm.npz"
    printed(app("kitti2mm").main, ["-i", pathlib.Path(tmp) / "frame0.bin", "-o", mm])
    res["mm_info"] = printed(app("mm_info").main, [mm])
    geo = out_dir / "geo.mm.npz"
    georef = app("mm_georef").main
    printed(georef, [mm, "--inject", pathlib.Path(tmp) / "georef.yaml", "-o", geo])
    res["georef"] = {"print": printed(georef, [geo]),
                     "geodetic_to_map": printed(georef, [geo, "--geodetic-to-map", cs.GEOREF_FIX]),
                     "map_to_geodetic": printed(georef, [geo, "--map-to-geodetic",
                                                         cs.GEOREF_POINT])}
    return res


def compare(jax_res, port_res):
    """The port's CPU run against the JAX package's: exact where exact,
    the normals' rows beyond NORMALS_BAND counted."""
    diffs = {"rawlog_equal": jax_res["rawlog"] == port_res["rawlog"],
             "sm_points_equal": jax_res["sm_filter"]["points"] == port_res["sm_filter"]["points"],
             "sm_line_equal": jax_res["sm_filter"]["line"] == port_res["sm_filter"]["line"],
             "mm_info_equal": jax_res["mm_info"] == port_res["mm_info"],
             "georef_equal": jax_res["georef"] == port_res["georef"],
             "with_normal_gaps": [a["with_normal"] - b["with_normal"] for a, b in zip(
                 port_res["rawlog_normals"], jax_res["rawlog_normals"])]}
    for key in jax_res["rawlog_normal_rows"]:
        far = cs.normals_beyond_band(cs.unpack_normals(port_res["rawlog_normal_rows"][key]),
                                     cs.unpack_normals(jax_res["rawlog_normal_rows"][key]))
        diffs[f"frame {key} normals beyond the band"] = [int(far.sum()), int(far.size)]
    return diffs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=cs.APPS_FRAMES)
    ap.add_argument("--rings", type=int, default=cs.APPS_RINGS)
    ap.add_argument("--azimuths", type=int, default=cs.APPS_AZIMUTHS)
    ap.add_argument("--keyframes", type=int, default=cs.SM2MM_KEYFRAMES)
    ap.add_argument("--port", action="store_true", help="also run the port's apps on the CPU")
    ap.add_argument("--write", help="also write the JAX package's JSON object to this file")
    args = ap.parse_args()

    mp2p_icp_tpu_torch.set_default_device("cpu")  # the inputs are made by the port's writers
    t_all = time.perf_counter()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, _, scans = cs.write_apps_sequence(pathlib.Path(tmp) / "sequence", args.frames,
                                             args.rings, args.azimuths)
        cs.write_rawlog(pathlib.Path(tmp) / "in.rawlog.npz", scans)
        cs.tools_inputs_frame0(scans[0], tmp)
        (pathlib.Path(tmp) / "tools.yaml").write_text(cs.TOOLS_YAML)
        (pathlib.Path(tmp) / "georef.yaml").write_text(
            yaml.safe_dump({"georeferencing": cs.GEOREF}))
        gt_o, twists_o, scans_o = cs.make_street_sequence(
            max(cs.ODO_FRAMES, args.keyframes), dt=cs.ODO_DT)
        sm, _ = cs.sm2mm_build(cs.sm2mm_inputs(gt_o, twists_o, scans_o,
                                               n_keyframes=args.keyframes), precise=False)
        sm.save(str(pathlib.Path(tmp) / "in.sm.npz"))
        most = max(largest_voxel_count(scans, 0.5),
                   max(len(np.unique(np.floor(np.asarray(o.xyz) / np.float32(0.5)), axis=0))
                       for kf in sm.keyframes for o in kf.observations))
        capacity = round_capacity(most + 1)
        results["size"] = {"frames": args.frames, "rings": args.rings, "azimuths": args.azimuths,
                           "keyframes": args.keyframes,
                           "raw_capacity": round_capacity(max(int(s["valid"].sum())
                                                              for s in scans)),
                           "most_05m_voxels": most, "jax_decimated_capacity": capacity}
        print(f"[reference] inputs in {time.perf_counter() - t0:.1f} s: {results['size']}",
              file=sys.stderr, flush=True)
        jax_res, out_dir = run_all(args, False, tmp, capacity)
        jax_res.update(run_small_apps(False, tmp, out_dir))
        results.update(jax_res)
        results["seconds"] = time.perf_counter() - t_all
        print(json.dumps(results))
        if args.write:
            pathlib.Path(args.write).write_text(json.dumps(results, indent=1) + "\n")
        if args.port:
            t0 = time.perf_counter()
            port_res, out_dir = run_all(args, True, tmp, capacity)
            port_res.update(run_small_apps(True, tmp, out_dir))
            port_res["seconds"] = time.perf_counter() - t0
            print(json.dumps({"port_cpu": port_res}))
            print(json.dumps({"port_cpu_against_jax": compare(jax_res, port_res)}))


if __name__ == "__main__":
    main()
