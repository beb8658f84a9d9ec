"""icp-run: ICP registration of two point clouds from files.

Port of ``mp2p_icp_tpu/apps/icp_run.py`` (reference:
apps/icp-run/main.cpp:226-334): load the local and global maps (.mm,
.mm.npz, KITTI .bin, .xyz[.gz]), run each side's filter pipeline from the
YAML config, align, print the results; optionally an initial guess, the
align's time with the host time of each of its spans (``--profiler``, as
the reference dumps its CTimeLogger's stats) and an .icplog.npz record.

Usage:
  python -m mp2p_icp_tpu_torch.apps.icp_run \\
      --input-local local.xyz --input-global global.mm -c pipeline.yaml \\
      [--guess "x y z yaw pitch roll"] [--profiler] [--out-log out.icplog.npz] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

from mp2p_icp_tpu_torch.apps import add_device_argument, on_device


def load_input_pc(path: str, device=None):
    """A metric map from any supported file (reference:
    apps/icp-run/main.cpp load_input_pc :117-223): a KITTI .bin or an .xyz
    file becomes the map's "raw" layer."""
    from mp2p_icp_tpu_torch.core.metric_map import MetricMap

    path = str(path)
    if path.endswith(".mm") or path.endswith(".mm.npz"):
        from mp2p_icp_tpu_torch.io.mm import load_mm_file

        return load_mm_file(path, device=device)
    if path.endswith(".bin"):
        from mp2p_icp_tpu_torch.io.kitti import load_kitti_bin

        return MetricMap(layers={"raw": load_kitti_bin(path, device=device)})
    from mp2p_icp_tpu_torch.io.xyz import load_xyz_file

    return MetricMap(layers={"raw": load_xyz_file(path, device=device)})


def side_pipeline(sections, cfg_file, entry_name, default_section):
    """One side's filter pipeline: a separate YAML file wins, then a named
    section of the main config, then ``default_section``, then "filters"
    (reference icp-run, main.cpp:62-96)."""
    if cfg_file:
        import yaml

        from mp2p_icp_tpu_torch.pipeline import filter_pipeline_from_yaml

        with open(cfg_file) as f:
            cfg = yaml.safe_load(f)
        return filter_pipeline_from_yaml(cfg.get("filters", []) if isinstance(cfg, dict) else cfg)
    if entry_name:
        return sections.get(entry_name, [])
    for sec in (default_section, "filters"):
        if sec in sections:
            return sections[sec]
    return []


def main(argv=None):
    ap = argparse.ArgumentParser(prog="icp-run", description="ICP registration of two point clouds")
    ap.add_argument("--input-local", required=True)
    ap.add_argument("--input-global", required=True)
    ap.add_argument("-c", "--config", required=True, help="YAML pipeline file")
    ap.add_argument("--guess", default="0 0 0 0 0 0",
                    help="initial guess: 'x y z yaw pitch roll' (radians)")
    ap.add_argument("--profiler", action="store_true",
                    help="print the align's time and its spans' host times")
    ap.add_argument("--out-log", default=None, help="save an .icplog.npz record of the run")
    ap.add_argument("--record-iterations", action="store_true",
                    help="store per-iteration poses in the log")
    ap.add_argument("--config-filters-local", default=None,
                    help="separate YAML file with a 'filters:' pipeline for the LOCAL map "
                         "(reference --config-filters-local); overrides the main config's")
    ap.add_argument("--config-filters-global", default=None,
                    help="separate YAML file with a 'filters:' pipeline for the GLOBAL map")
    ap.add_argument("--entry-name-filters-local", default=None,
                    help="section of the main config with the LOCAL map's pipeline "
                         "(default: filters_local_map, then filters)")
    ap.add_argument("--entry-name-filters-global", default=None,
                    help="section of the main config with the GLOBAL map's pipeline")
    ap.add_argument("-d", "--generate-debug-log", action="store_true",
                    help="write the .icplog debug files for icp-log-viewer whatever the "
                         "YAML's generateDebugFiles says (reference argGenerateDebugFiles)")
    add_device_argument(ap)
    args = ap.parse_args(argv)

    import numpy as np

    from mp2p_icp_tpu_torch.core import se3
    from mp2p_icp_tpu_torch.filters import apply_filter_pipeline
    from mp2p_icp_tpu_torch.icp import IterTermReason
    from mp2p_icp_tpu_torch.pipeline import load_icp_config_file
    from mp2p_icp_tpu_torch.utils import Profiler

    with on_device(args.device) as device:
        icp, params, sections = load_icp_config_file(args.config)
        if args.record_iterations:
            params = dataclasses.replace(params, record_iterations=True)
        if args.generate_debug_log:
            params = dataclasses.replace(params, generate_debug_files=True,
                                         save_iteration_details=True)
        local_mm = load_input_pc(args.input_local, device)
        global_mm = load_input_pc(args.input_global, device)
        for mm, pipe in (
                (local_mm, side_pipeline(sections, args.config_filters_local,
                                         args.entry_name_filters_local, "filters_local_map")),
                (global_mm, side_pipeline(sections, args.config_filters_global,
                                          args.entry_name_filters_global, "filters_global_map"))):
            if pipe:
                apply_filter_pipeline(pipe, mm)

        guess = se3.from_xyz_ypr(*[float(x) for x in args.guess.split()], device=device)
        prof = Profiler(enabled=args.profiler)
        t0 = time.perf_counter()
        with prof.installed():
            res = icp.align(local_mm, global_mm, guess, params)
        t = res.optimal_tf.t.cpu().numpy()  # the fetch waits for the align
        dt = time.perf_counter() - t0
        q = se3.rot_to_quat(res.optimal_tf.R).cpu().numpy()
        print("ICP result:")
        print(f"  translation : [{t[0]:.6f}, {t[1]:.6f}, {t[2]:.6f}]")
        print(f"  quat (wxyz) : {np.asarray(q).round(6).tolist()}")
        print(f"  iterations  : {int(res.n_iterations)}")
        print(f"  termination : {IterTermReason(int(res.termination_reason)).name}")
        print(f"  quality     : {float(res.quality):.4f}")
        print(f"  pairings    : {int(res.final_pairings.size())}")
        if args.profiler:
            print(f"  align time  : {dt * 1e3:.1f} ms (host clock, on {device})")
            print("spans (host clock; a span measures the launches it issues, not the work):")
            print(prof.report())
        if args.out_log:
            from mp2p_icp_tpu_torch.io.icplog import save_log

            save_log(args.out_log, local_mm, global_mm, guess, res)
            print(f"  log saved   : {args.out_log}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
