#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU, end to end, and check it.

    python3 chip_smoke.py [--profile]

Phases (each prints its lines; any failure raises and exits non-zero):

1. name the card (nvidia-smi name and power limit); no CUDA -> fail;
2. build the CUDA kernels from mp2p_icp_tpu_torch/csrc (the three kNN
   sweeps, the Gauss-Newton solve and the ICP loop's termination test),
   one nvcc each, all at once; print
   the registers, spills and shared memory of the k = 1 and k = 8
   instantiations;
3. hold each kNN kernel against its plain PyTorch version on the card, bit
   for bit (max |d2 - d2_plain| must be 0): K1 on two 8192-point street
   scans for k=1 and k=8, a ragged 777x3001 case with invalid rows for k=4
   and k=5 and a per-query radius, and two 1081-row planar scans for k=4
   and k=5 (the 2D demo's Point2Line); K3 (the streamed sweep) on 8192 scan points against a
   262144-point corridor map for k=1 and k=8 and a ragged case; K2 (the
   batched sweep) on 8 scans of 8192 points against 8 maps of 65536 points
   and against one shared map, on the B = 16 scan-to-scan batch's 16 x 8192
   x 8192 k=1 (each pair's local scan against its own global scan), plus a
   ragged case; then, for each kernel
   and k in {1, 8}, the cases that stress the split of the point axis:
   points on an integer grid with duplicates (so the order of the merge
   decides every tie), Q = 1, 777 and 5000, fewer points than one tile and
   than one block has warps, a batch whose stride is not 16-byte aligned
   (C = 3001), the odometry shapes 6144x16384 (k=1), 2048x22528 and
   6144x6144 (k=8: the normals fit of a frame and of the seed), and K2 at
   the fleet step's shapes on street scans: 8x6144x16384 (k=1) and
   8x2048x22528 (k=8); and the YAML phase's K1 shapes: the 2D demo's
   generated layers (1024x1024, k=1 and 5) and the normals filter's
   65536x65536 k=8 on a decimated street frame.
   The counted sweeps (a front end passes each side's count of leading rows
   that hold every valid row, nn_bruteforce.valid_count, read on the
   device): K1 on street points under nine kinds of mask (prefix,
   scattered, no valid point, one, fewer than k, one valid query, counts of
   4n + 1, 2, 3) for k = 1, 5 and 8, each also through the front end
   against the uncounted sweep's NNResult (equal to the bit); integer grids
   at k = 2, 4, 5 and 8 with counts through K1, and through K2 with
   per-problem counts against a map per problem and one shared map; the
   batched front end and torch.func.vmap with per-problem counts; a counted
   K1 and K2 front-end call captured in a CUDA graph and replayed on
   changed masks; and each padded shape of the later phases again with the
   counts its path passes, its [launch] line giving its valid rows beside
   its capacity. The counts of compare cases without and with counts are
   printed.
   Times: each kernel at every shape its path (or the odometry step)
   gives it, as device time per launch of a CUDA graph of 20 wrapper
   calls and as the time of one call between CUDA events (which includes
   the host's part of the call), taken in turns, beside its bound, its
   plain version and the library call (torch.cdist + topk);
   then the Gauss-Newton kernel (csrc/gn_solve.cu) at the cells' shapes, 1 x
   6144 pt2pl, 1 x 8192 pt2pt and 8 x 6144 pt2pl (one vmapped launch): each
   pose within 1 float32 ulp of the plain float64 path's, its time in a
   CUDA graph of 20 calls and alone, beside its bounds (the card's, one
   SM's) and the plain path's time ([gn] lines); then the termination
   kernel (csrc/icp_terminate.cu) at the cells' shapes, 1 x 6144 pt2pl,
   1 x 8192 pt2pt and 8 x 6144 pt2pl (one vmapped launch): flags, kept
   pose and step norms bit-equal to the plain path's, its time in a CUDA
   graph of 20 calls and alone, beside its bound (the bytes it reads and
   writes) and the plain path's time ([term] lines);
4. the scan-to-scan path: ICP.align with the KITTI configuration on the
   bench street pair at 8192 points, then 8 further pairs served one after
   another; each SE(3) error must be < 0.1 and K1's launch count must equal
   the number of matcher calls; one pair is also aligned on the CPU (plain
   path) and its pose compared with the GPU's;
5. the scan-to-large-map path (bench.py:367-522): an 8192-point scan
   against 1M, 2M and 16M-point corridor maps, cropped at the guess to
   2^16 (K1), 2^18 (K3) and 2^18 (K3) points; SE(3) error < 0.1, launches
   of the path's kernel == matcher calls, iterations and termination
   printed beside the JAX CPU reference;
6. the batched path (bench.py:419-482): 8 scans against the shared 1M map
   in one make_batched_align call; each SE(3) error < 0.1, each pose
   within 1e-5 of the port's sequential align on the card with the same
   iterations and termination, K2 launches == matcher calls, no K1 launch;
   then the B = 16 scan-to-scan batch (bench.py:219-253: pairs 100 + 2b /
   101 + 2b of the bench scene, each its own map, the KITTI configuration,
   no broadcast) in one call, twice, with the same checks against phase 4's
   and further sequential aligns;
7. the odometry path (bench.py:580-683): the 36-frame street drive (48
   rings x 768 azimuths, raw capacity 2^16) through OdometryMapper.run
   with dt = 0.1: deskew, FirstPoint decimation at 0.5 m into 6144 rows,
   crop of the 2^15-row map to 2^14, stored-normal point-to-plane +
   Gauss-Newton, voxel-hash insert, k=8 normals fit of the new voxels;
   once cold and once warm. ATE < 0.1 m and within max(1.5x, +0.01 m) of
   the JAX CPU reference, map count within 2% of it, every quality finite,
   K1 launches == matcher calls + one normals fit per frame + the seed's,
   no K2/K3 launch, one Gauss-Newton and one termination launch per ICP
   iteration; the map insert run twice on the same input gives equal
   states;
8. the fleet path (bench.py:738-776): 8 streams of 20 frames, stream b =
   frames [2b, 2b+20) of the street drive with its twists and its true
   start pose, through BatchedOdometryMapper.run once and .run_offline once
   cold and once warm; OdometryMapper.run_offline on the 36 frames; and
   the 8 streams one after another through OdometryMapper.run. Each
   stream's fleet poses must equal its sequential poses (R and t within
   1e-5) with the same iterations per frame, the same final map count and
   nothing dropped; run_offline must equal run to the bit, for one stream
   and for the fleet; each stream's ATE must lie within max(1.5x, +0.01 m)
   of the JAX CPU reference for that stream and its map count within 2%;
   K2 launches == the fleet's ICP iterations (the slowest stream's, frame
   by frame) + one normals fit per fleet frame, K1 launches == the 8
   seeds, no K3 launch. Printed: aggregate scans/s of the fleet beside the
   sequential streams', ms per fleet frame against the 100 ms period,
   iterations, K2 launches, host reads and probe rounds per fleet frame;
9. the rest of the ICP engine: (a) the bench pair with a voxel grid of each
   scan (0.2 m, from the sensor) through engine_icp(): InlierRatio(0.8) +
   OLAE for iterations 0-5, then Adaptive with its plane stage (K1 k=8)
   and an ICP_ITERATION expression for its search distance + Gauss-Newton;
   the paired-ratio, voxel and range-image qualities; the scale of a Horn
   solver that never solves; 40 iterations recorded with their pairings
   and a debug file per align into chiprun_out/engine/; three runs: a hook
   that never stops, no hook, a hook that stops at iteration 4. (b) the 2D
   demo (Point2Line k=5 + DistanceThreshold + Gauss-Newton) on 9 pairs of
   planar Hokuyo UTM-30LX scans (1081 rays) of the street scene 0.3 m and
   2° apart, from a motion-model guess. Each align: termination, iterations
   and pose against the JAX CPU reference (scripts/torch_engine_reference.py),
   SE(3) error < 0.1 (not for the stopped run), K1 launches == matcher
   calls; the passive hook equals no hook to the bit, the stopping hook ends
   with HOOK_REQUEST after 5 iterations, the 40 records end in the final
   pose, the debug file loads; launches and ms per align printed;
10. map building from keyframes: demos/sm2mm_voxelmap_static_dynamic.yaml,
   loaded by the port's loader, on the first 24 frames of the street drive
   as a SimpleMap (true poses, noisy twists, a moving box in each
   keyframe) through simplemap_to_metricmap: pass 1 as the file stands
   (constant-twist deskew), pass 2 with the precise deskew (IMU samples and
   a comment's velocity buffer in each keyframe). Map points, voxel count
   and key sums, sampled voxels, static / dynamic counts, map sums and the
   last keyframe's deskewed rows held to the JAX CPU reference
   (scripts/torch_sm2mm_reference.json); ms, launches and host syncs per
   keyframe (torch.profiler over one warm pass), ms of the final filters;
11. the YAML demos: icp-settings-kitti.yaml (equal to kitti_icp() module for
   module, up to its layer names; its FirstPoint section on the bench
   pair), icp-settings-example1.yaml (two ClosestToAverage sections, a
   bunny-sized pair) and the 2D demo (its generators decode the planar
   pairs' range scans; equal to point2line_icp()), each align held to the
   JAX CPU reference and K1's launches to the matcher calls; one street
   frame through a YAML pipeline of every ported filter (K1 65536² k=8 for
   the normals), each output layer held to the reference;
12. the command-line entry points (mp2p_icp_tpu_torch/apps) on a KITTI-format
   sequence: 40 frames of the street drive at HDL-64E geometry (64 rings x
   2048 azimuths, 131072 rays a scan) written as 16-byte .bin rows and
   gt.txt under chiprun_out/apps/; kitti_odometry.main sequentially
   (demos/icp-settings-kitti.yaml, constant-velocity guess; K1), with
   -B 8 (make_batched_align; K2) and with --mapping --map-capacity 2^18
   --out-map (OdometryMapper against the map cropped to 131072 rows; K1):
   ATE, RPE, iterations and ms per frame beside the JAX CPU reference
   (scripts/torch_apps_reference.json), ATE within max(1.5x, +0.01 m) of
   it, the mode's kernel launched once per matcher call and no other;
   the new K1 and K2 shapes (the decimated layer keeps the raw capacity)
   held to their plain versions and timed; icp_run.main on frames 1 and 0
   from .xyz.gz and from MRPT binary .mm files (pose within 5e-3 of the
   JAX CPU reference, same termination, iterations +-1, the --out-log
   file loads); mm_filter.main with the five structured filters and a
   ClosestToAverage decimation on frame 0 (.mm.npz with its ring and time
   channels), each output layer's count and sums held to the reference,
   FilterEdgesPlanes' rows on threshold voxels counted and allowed to
   differ; sm2mm_app.main on phase 10's pass-1 simple map saved to disk
   (map counts equal phase 10's) and sm_cli info and cut on that file;
13. the map tools (mp2p_icp_tpu_torch/apps, core/geodesy.py, utils/profiler.py,
   ops/voxel_hash.py + ops/nn.nn_search), each held to the JAX CPU reference
   constants of scripts/torch_tools_reference.json (written by
   scripts/torch_tools_reference.py): (a) rawlog_filter.main over phase
   12's 40 frames at HDL-64E geometry as a .rawlog.npz with TOOLS_YAML
   (generator, range, FirstPoint 0.5 m, normals k=8): per frame the
   observation and out_<layer> of its three point layers, rows exact and
   sums as JAX's, the normals its run fitted within 1e-3 of JAX's but for
   at most 5% of a frame's rows (counted), one K1 launch a frame, ms a
   frame; the new K1 shape (the decimated layer at the raw capacity
   against itself, k=8) compared with its plain version and timed; (b)
   sm_filter.main with the same YAML on phase 10's pass-1 simple map: the
   decimated rows of each keyframe as JAX's; (c) mm_georef.main on phase
   12's map: --inject / --extract of an anchor near Karlsruhe with a 30°
   yaw, JAX's --geodetic-to-map / --map-to-geodetic lines, --to-enu's rows
   on the card equal to the host's float64 geodesy or 1 ulp from it
   (counted); (d) txt2mm -> mm2txt and kitti2mm -> mm_info on frame 0: the
   columns back, JAX's mm-info line; (e) mm_viewer --html on the map and
   icp_log_viewer --html + text on an icp-run log: byte for byte their
   --device cpu output; (f) nn_search over a HashGrid of decimated frame 0
   (cell 1 m) for frame 1's points, k = 1 and 8, radius^2 0.99, against K1
   (the same neighbours but for ties, a colliding bucket's duplicates and
   overfull buckets, each counted; d2 within 1 ulp) and equal to its CPU
   run; (g) every call in a utils.Profiler span, its report printed, one
   span found among a torch.profiler trace's events. The inputs are
   deleted at the end;
14. the pose graph, loop closure and the sharded paths, each held to the
   JAX CPU reference constants of scripts/torch_parallel_reference.json
   (written by scripts/torch_parallel_reference.py): (a) a pose graph at
   KITTI 00's length (4,541 nodes lapping a 75 m circuit 8 times, 4,540
   odometry and 398 loop edges, ``lap_graph``) through optimize_pose_graph
   (dense Cholesky of the [6N, 6N] system in float64) and
   optimize_pose_graph_cg (2,000 CG steps per Gauss-Newton iteration), each
   twice (equal to the bit), CG's chi2 within 1e-4 relative of dense's and
   its poses within PG_CG_BAND of JAX's CG, the dense solve of a 1,000-node
   graph within PG_DENSE_BAND of JAX's; ms per Gauss-Newton iteration, chi2
   before and after; (b) kitti-odometry --mapping --loop-closure on a
   48-frame out-and-back drive at HDL-64E geometry (``write_loop_sequence``,
   under chiprun_out/loop/, deleted after) with the ground-cropped YAML:
   JAX's candidates, accepted loops and printed line, ATE after the closure
   within max(1.5x, +0.01 m) of JAX's and no worse than before, K1 launches
   == the mapping's and the closure aligns' matcher calls; (c) several
   ranks on the one card over gloo (parallel/launch.spawn_ranks; NCCL
   refuses two ranks on one GPU): 4 ranks for the sharded kNN of an
   8192-point scan over the 1M corridor map in 4 shards of 262144 rows (K3
   on each rank; equal to one sweep of the whole map to the bit, k = 1 and
   8), make_spatial_align against the 1M and 2M maps (each rank crops its
   shard: K1 / K3; the one-process align to the bit where no crop
   overflows; a third case, the 1M map with a crop of 2^19, overflows
   nowhere) and the sharded pose graph (dense on 1,000 nodes, CG with 200
   steps on 4,541; within 1e-3 m of one rank); 2 ranks started by init_from_env from
   the MP2P_* variables for SpatialOdometryMapper on phase 7's drive
   (incremental map; no voxel on two shards, ATE within max(1.5x, +0.01 m)
   of JAX's over 2 devices, the union's voxels Jaccard >= 0.97 against
   phase 7's map) and phase 6's batch split over the data axis (K2 on each
   rank; equal to the one-process batch to the bit). Each rank's launches
   are counted in its process and printed, with ms beside the one-process
   path's;
15. data x space: 4 ranks on the one card over gloo, started by
   init_from_env, as a 2 x 2 mesh (2 data rows of 2 space ranks): (a)
   phase 6's 8 scans of 8192 points against the shared 1M corridor map,
   each space rank holding a 524288-row shard and each data rank 4 scans,
   through make_batched_align(..., space=) with each shard cropped at each
   scan's guess, the crop capacity sized to keep every in-box row of a
   shard (checked and printed; the one-process reference keeps every
   in-box row of the whole map: phase 6's 2^16 crop, or phase 6's batch
   re-run at the wider crop): R, t, iterations and termination equal to the
   one-process batch to the bit on every rank, K2 launches per rank ==
   matcher calls (no K1, K3), one all_gather over space per matcher call,
   ms per call beside the one-process batch's; (b) the JAX dry run's
   problems (scripts/torch_multichip_dryrun.py: 4 uniform 256-point
   clouds, each its own map), B = 4 on the mesh, equal to the one-process
   batch to the bit and within the align band of the JAX package's data x
   space run on 8 CPU devices (scripts/torch_parallel_reference.json,
   "data_space"); (c) K2 at a rank's shape, 4 x 8192 x the cropped shard's
   rows, k = 1, against knn_plain_batched bit for bit, timed in a CUDA
   graph beside its bound and cdist + topk; (d)
   scripts/torch_multichip_dryrun.py 4 as a subprocess (gloo: one card
   for 4 ranks), its tail printed, a non-zero exit failing the phase;
16. bench_torch.py (the port's benchmark, the twin of bench.py) at full size
   in a process of its own: exit 0, one stdout line with every key of
   bench.py's line (BENCH_r05.json's names) plus device and power_limit_w,
   backend "cuda", every SE(3) error < 0.1, the bench pair's iterations
   within 1 of the JAX CPU reference's 12, the odometry ATE within
   max(1.5x, +0.01 m) and its map count within 2% of ODO_JAX; its stderr in
   chiprun_out/bench_torch.log, its line printed, its kernels' launches
   added to the paths';
17. with --profile only: where the time goes, by torch.profiler over 2
   warm calls (device busy share, launches, the kNN kernels' time) of a
   scan-to-scan align, a scan to the 2M map and the batched call, then
   per-section host times of a scan-to-scan align with a sync around each
   section; then the odometry run: torch.profiler over one warm run of the
   36 frames (busy share, launches and host syncs per frame, probe rounds
   per map insert, K1's time by k) and per-stage times with a sync around
   each stage; the same for one warm fleet run; then 2 warm aligns of each
   engine cell and the sections of a 3D engine align with a sync around
   each; the profiler's tables go to chiprun_out/profile_tables.txt;
18. one JSON line with the kernels' numbers (each shape's time, bound,
   plain version and library call, torch.cdist + topk in a CUDA graph;
   for gn_solve and icp_terminate, which replace no TPU kernel, the [gn]
   and [term] rows, the largest gap to the plain path and no library
   call) and their launches by path
   (every path zeroes the counts just before its run and reads them just
   after), then the last line {"ok": true, "device": {...}}.

The workloads and configurations (kitti_icp, street_pair, corridor_scene,
local_window, sensor_scan, map_icp, odometry_mapper, odometry_frames) are
bench_torch.py's, imported from there.

The port's constructors put their tensors on the card by default; this
script passes ``device=`` only where it asks for the CPU (to prepare the
scans as before, for the CPU comparison of phase 4 and for the poses of
the street drive).

Every kernel's launch count is set to 0 just before each path and read
just after it. Imports torch, numpy and the port; nothing of the JAX side.
The JAX CPU reference values are constants here;
scripts/torch_odometry_reference.py produces the odometry run's and, with
--fleet, the fleet's; scripts/torch_engine_reference.py the engine
phase's; scripts/torch_sm2mm_reference.py writes the sm2mm and YAML
phases' to scripts/torch_sm2mm_reference.json,
scripts/torch_apps_reference.py the apps phase's to
scripts/torch_apps_reference.json, scripts/torch_tools_reference.py the
tools phase's to scripts/torch_tools_reference.json and
scripts/torch_parallel_reference.py phase 14's to
scripts/torch_parallel_reference.json, which this script reads. The ranks
of phase 14 run functions of
mp2p_icp_tpu_torch/parallel/ranks.py in processes of their own; each
loads the kernels phase 2 built.
"""

import argparse
import base64
import contextlib
import dataclasses
import io
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import yaml

from bench_torch import (  # the benchmark's workloads and configurations
    GT,
    N_POINTS,
    ODO_DT,
    ODO_RESOLUTION,
    corridor_scene,
    kitti_icp,
    local_window,
    map_icp,
    odometry_frames,
    odometry_mapper,
    sensor_scan,
    street_pair,
)
from mp2p_icp_tpu_torch import default_device
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.metric_map import VoxelGridLayer
from mp2p_icp_tpu_torch.core.pairings import Pairings
from mp2p_icp_tpu_torch.core.params import Expression
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.eval.gn_problem import gn_problem
from mp2p_icp_tpu_torch.eval.lidar_sim import (
    make_scene,
    make_street_scene,
    make_street_sequence,
    planar_points,
    render_planar_ranges,
    render_spinning_scan,
    sample_scan,
    scan_to_pointcloud,
)
from mp2p_icp_tpu_torch.eval.trajectory import ate_rmse
from mp2p_icp_tpu_torch.filters import FilterDecimateVoxels, FilterDeskew
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters, IterTermReason
from mp2p_icp_tpu_torch.io import debug_dump, icplog
from mp2p_icp_tpu_torch.matchers import (
    LayerMatch,
    MatcherAdaptive,
    MatcherPoint2Line,
    MatcherPointsDistanceThreshold,
    MatcherPointsInlierRatio,
)
from mp2p_icp_tpu_torch.odometry import BatchedOdometryMapper
from mp2p_icp_tpu_torch.ops import cuda_build, icp_terminate
from mp2p_icp_tpu_torch.ops import nn_bruteforce as nnb
from mp2p_icp_tpu_torch.ops.voxel_hash_map import hash_map_insert
from mp2p_icp_tpu_torch.ops.voxel_occupancy import update_voxel_map
from mp2p_icp_tpu_torch.parallel import make_batched_align, stack_pytrees
from mp2p_icp_tpu_torch.parity import knn_mismatch
from mp2p_icp_tpu_torch.quality import (
    QualityPairedRatio,
    QualityRangeImageSimilarity,
    QualityVoxels,
)
from mp2p_icp_tpu_torch.solvers import gauss_newton, solver
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.robust import RobustKernel
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn, SolverOLAE

N_REQUESTS = 8
ERR_LIMIT = 0.1  # the reference's end-to-end bound on ||log(gt^-1 T)||
# kernel (its library in cuda_build.LIBRARIES) -> the TPU kernel of the JAX
# package it replaces; None: one of the port's own (the JAX package solves
# Gauss-Newton and tests termination with XLA's ops, not with a kernel)
REPLACES = {
    "knn_bruteforce": "mp2p_icp_tpu/ops/nn_bruteforce.py:154",  # _nnk_kernel_gridless
    "knn_streamed": "mp2p_icp_tpu/ops/nn_bruteforce.py:509",  # _nnk_kernel_streamed_dbuf
    "knn_batched": "mp2p_icp_tpu/ops/nn_bruteforce.py:214",  # _nnk_kernel_gridless_batched
    "gn_solve": None,
    "icp_terminate": None,
}


def source(name):
    """A kernel's CUDA source, from the repository's root."""
    return f"mp2p_icp_tpu_torch/csrc/{cuda_build.LIBRARIES[name][0]}"


# the scan-to-map problem of bench.py:367-408 and the JAX package's result
# for it on the CPU (SE(3) error, iterations, termination)
MAP_CASES = (("1M", 1 << 20, 1 << 16, (0.00133, 30, "STALLED")),
             ("2M", 1 << 21, 1 << 18, (0.00087, 33, "STALLED")),
             ("16M", 1 << 24, 1 << 18, (0.00139, 32, "STALLED")))
# warm aligns timed per map (bench_torch.py, phase 16, times 10, 10 and 5)
MAP_TIMED = {"1M": 1, "2M": 1, "16M": 1}
BATCH = 8
PAIR_BATCH = 16  # bench.py:220: the scan-to-scan batch, each pair with its own map
# the least time the card can take: the kernels issue 9 FP32 instructions
# per pair (3 sub, 3 mul, 2 add, 1 compare), none an FMA, so its 67 TFLOP/s
# (NVIDIA's data sheet, H100 SXM) are 33.5 T instructions/s; the bytes
# (each point, query and result once) at 3.35 TB/s are far less
FP32_INSTRUCTIONS_PER_S = 67.0e12 / 2
BYTES_PER_S = 3.35e12
GRAPH_LAUNCHES = 20
# JAX CPU reference of the batched problem (bench.py:431-463): iterations
# per problem, all STALLED, SE(3) errors 0.0012-0.0081
BATCH_JAX_ITERS = [17, 27, 24, 19, 25, 34, 28, 15]
# the odometry run (bench.py:580-683) and the JAX package's result for the
# same frames on the CPU (scripts/torch_odometry_reference.py): ATE in
# metres, map points, mean ICP iterations per frame
ODO_FRAMES = 36
ODO_JAX = {"ate_m": 0.026013, "map_points": 13796, "iterations_mean": 3.69}
ATE_LIMIT = 0.1
# the fleet (bench.py:738-752): stream b = frames [2b, 2b + 20) of the drive.
# The JAX package's OdometryMapper.run on each stream on the CPU
# (scripts/torch_odometry_reference.py --fleet; its own test holds its
# batched run to these sequential runs): ATE in metres, map points, mean
# ICP iterations per frame; frame by frame the slowest stream takes 4.79
FLEET_STRIDE = 2
FLEET_FRAMES = ODO_FRAMES - BATCH * FLEET_STRIDE
FLEET_JAX = (
    {"ate_m": 0.033288, "map_points": 11665, "iterations_mean": 3.58},
    {"ate_m": 0.015307, "map_points": 11343, "iterations_mean": 3.63},
    {"ate_m": 0.013923, "map_points": 10456, "iterations_mean": 3.16},
    {"ate_m": 0.014438, "map_points": 10662, "iterations_mean": 3.26},
    {"ate_m": 0.020158, "map_points": 10357, "iterations_mean": 3.21},
    {"ate_m": 0.014085, "map_points": 10391, "iterations_mean": 3.37},
    {"ate_m": 0.029321, "map_points": 10214, "iterations_mean": 3.53},
    {"ate_m": 0.012371, "map_points": 10192, "iterations_mean": 3.32},
)
SENSOR_PERIOD_MS = 100.0
# the engine phase. (a) the bench pair through every ported module of the
# KITTI configuration's shape: InlierRatio + OLAE, then Adaptive with its
# plane stage + GN. Adaptive's search distance shrinks with the iteration;
# the conditional form is the one the JAX package can trace (it cannot
# trace max()); the port evaluates both alike (tests/test_torch_params.py).
ENGINE_AMSD = "2.0 - 0.05*ICP_ITERATION if ICP_ITERATION < 30 else 0.5"
ENGINE_VOXEL = 0.2  # m, the quality's voxel grids
ENGINE_VOXEL_CAPACITY = 1 << 18
ENGINE_HOOK_STOP = 4  # the stopping hook asks to stop at this iteration
ENGINE_RUNS = ("passive hook", "no hook", "stopping hook")
# (b) the repo's 2D demo (demos/icp-settings-2d-lidar-point2line.yaml) on
# planar scans of a Hokuyo UTM-30LX (1081 rays over 270°, 30 m, 1 cm noise)
PLANAR_RAYS = 1081
PLANAR_PAIRS = 9
# the JAX package's results on the CPU for the same inputs
# (scripts/torch_engine_reference.py): per align the termination, the
# iterations, the quality, the SE(3) log of the pose and, for (a), the
# optimal scale
ENGINE_JAX = {
    "no hook": {"termination": "STALLED", "iterations": 16, "quality": 0.6236061,
         "log": (1.09902418, 0.0444164686, 0.0101635447, 0.000938779442, 0.00193622755, 0.0100073498),
         "scale": 0.99992311},
    "stopping hook": {"termination": "HOOK_REQUEST", "iterations": 5, "quality": 0.6007239,
         "log": (0.695601583, 0.0538067892, -0.00448792847, 0.00129813573, 0.00255716499, 0.00631007645),
         "scale": 0.999772191},
}
PLANAR_JAX = (
    {"termination": "STALLED", "iterations": 19, "quality": 0.4592338,
         "log": (0.306635886, -0.0053620832, 0, 0, 0, 0.035051275)},
    {"termination": "STALLED", "iterations": 22, "quality": 0.4487805,
         "log": (0.283793718, -0.00720804837, 0, 0, 0, 0.0348525941)},
    {"termination": "STALLED", "iterations": 18, "quality": 0.4703018,
         "log": (0.307189047, -0.00556483632, 0, 0, 0, 0.0351906419)},
    {"termination": "STALLED", "iterations": 21, "quality": 0.4698672,
         "log": (0.288160175, -0.00507450942, 0, 0, 0, 0.0348636135)},
    {"termination": "STALLED", "iterations": 23, "quality": 0.4761905,
         "log": (0.307327837, -0.00553480815, 0, 0, 0, 0.0347314179)},
    {"termination": "STALLED", "iterations": 45, "quality": 0.4241206,
         "log": (0.327548712, -0.00837845914, 0, 0, 0, 0.0351593122)},
    {"termination": "STALLED", "iterations": 20, "quality": 0.4594986,
         "log": (0.299483955, -0.00490794005, 0, 0, 0, 0.0350357853)},
    {"termination": "STALLED", "iterations": 14, "quality": 0.466407,
         "log": (0.297767013, -0.00398818124, 0, 0, 0, 0.0347890519)},
    {"termination": "STALLED", "iterations": 42, "quality": 0.4557477,
         "log": (0.325476736, -0.00682603428, 0, 0, 0, 0.0347819701)},
)
# the 2D demo's stall tail creeps (steps of 1-3e-4 m against its 1e-4
# threshold), and the JAX package's kNN distances are off by up to 1e-3 m²
# against a 0.0225 m² threshold at 30 m: a pair that flips moves the stall
# by several iterations with poses 1e-3 m apart (the CPU preview of
# scripts/torch_engine_reference.py: pair 4 stalls at 18 in the port, 23 in
# JAX, 9e-4 apart). Its iterations are held to ±25% of JAX's (at least ±1).
PLANAR_ITERATION_BAND = 0.25
# the map-building phase: the first SM2MM_KEYFRAMES frames of the street
# drive as a simple map (true poses, noisy twists) through the repo's demo
# YAML, each keyframe with a moving box of SM2MM_BOX points, 5 m further
# along the street per keyframe and 4 m beside the track; pass 2 turns on
# the precise deskew and adds IMU samples at IMU_RATE and a comment with a
# local velocity buffer to every keyframe
REPO = pathlib.Path(__file__).resolve().parent
DEMOS = REPO / "demos"
SM2MM_KEYFRAMES = 24
SM2MM_BOX = 600
IMU_RATE = 200.0
SM2MM_SAMPLES = 16  # voxels and deskewed rows compared one by one
# the YAML phase's pipeline of every filter of the library that the port
# has, on one street frame ("raw", 48 rings x 768 azimuths)
ALL_FILTERS_YAML = """
filters:
  - class_name: mp2p_icp_filters::FilterByRange
    params: {input_pointcloud_layer: raw, output_layer_between: near,
             output_layer_outside: far, range_min: 3.0, range_max: 30.0}
  - class_name: mp2p_icp_filters::FilterBoundingBox
    params: {input_pointcloud_layer: raw, inside_pointcloud_layer: box_inside,
             outside_pointcloud_layer: box_outside,
             bounding_box_min: [-20.0, -6.0, -2.0], bounding_box_max: [20.0, 6.0, 1.0]}
  - class_name: mp2p_icp_filters::FilterByRing
    params: {input_pointcloud_layer: raw, output_layer_selected: rings_low,
             output_layer_non_selected: rings_other, selected_ring_ids: [0, 1, 2, 3, 4, 5, 6, 7]}
  - class_name: mp2p_icp_filters::FilterByIntensity
    params: {input_pointcloud_layer: raw, output_layer_low_intensity: dim,
             output_layer_mid_intensity: mid, output_layer_high_intensity: bright,
             low_threshold: 0.2, high_threshold: 0.5}
  - class_name: mp2p_icp_filters::FilterNormalizeIntensity
    params: {pointcloud_layer: mid}
  - class_name: mp2p_icp_filters::FilterAdjustTimestamps
    params: {pointcloud_layer: rings_low, method: TimestampAdjustMethod::Normalize,
             time_offset: 0.5}
  - class_name: mp2p_icp_filters::FilterDecimateVoxels
    params: {input_pointcloud_layer: near, output_pointcloud_layer: dec_first,
             voxel_filter_resolution: 0.5, decimate_method: DecimateMethod::FirstPoint}
  - class_name: mp2p_icp_filters::FilterDecimateVoxels
    params: {input_pointcloud_layer: near, output_pointcloud_layer: dec_random,
             voxel_filter_resolution: 0.5, decimate_method: DecimateMethod::RandomPoint}
  - class_name: mp2p_icp_filters::FilterDecimateVoxels
    params: {input_pointcloud_layer: near, output_pointcloud_layer: dec_average,
             voxel_filter_resolution: 0.5, decimate_method: DecimateMethod::VoxelAverage}
  - class_name: mp2p_icp_filters::FilterDecimateVoxels
    params: {input_pointcloud_layer: near, output_pointcloud_layer: dec_closest,
             voxel_filter_resolution: 0.5, decimate_method: DecimateMethod::ClosestToAverage}
  - class_name: mp2p_icp_filters::FilterDecimateVoxelsQuadratic
    params: {input_pointcloud_layer: raw, output_pointcloud_layer: dec_quadratic,
             voxel_filter_resolution: 0.1, quadratic_reference_radius: 10.0}
  - class_name: mp2p_icp_filters::FilterDecimateAdaptive
    params: {input_pointcloud_layer: raw, output_pointcloud_layer: dec_adaptive,
             desired_output_point_count: 4000}
  - class_name: mp2p_icp_filters::FilterEstimateNormals
    params: {input_pointcloud_layer: dec_first, knn: 8, max_radius: 2.0}
  - class_name: mp2p_icp_filters::GeneratorVoxelMap
    params: {input_pointcloud_layer: raw, output_voxel_layer: voxelmap, resolution: 0.5,
             capacity: 65536}
  - class_name: mp2p_icp_filters::FilterVoxelSlice
    params: {input_layer: voxelmap, output_layer: gridmap, slice_z_min: 0.0, slice_z_max: 2.0}
  - class_name: mp2p_icp_filters::FilterDeleteLayer
    params: {pointcloud_layer_to_remove: [far, rings_other]}
"""
# the example1 demo is tuned for the bunny, one 15 cm scan under two poses
# (0.01 m voxels and threshold). Its pair here: the bench pair's global scan
# shrunk EXAMPLE1_SCALE times (to +-1.2 m) and the same scan moved by
# EXAMPLE1_GT, from the identity. (At the bench pair's +-60 m the JAX
# package's kNN distances are off by up to 2.4e-3 m^2, 24 times the
# demo's 1e-4 m^2 threshold; ROADMAP C.)
EXAMPLE1_SCALE = 50.0
EXAMPLE1_GT = (0.004, -0.003, 0.001, 0.005, -0.002, 0.003)
# the JAX package's results on the CPU for the same inputs: the file that
# `JAX_PLATFORMS=cpu python3 scripts/torch_sm2mm_reference.py --write
# scripts/torch_sm2mm_reference.json` writes (564 s on a CPU); main() reads
# it into SM2MM_JAX ("sm2mm") and YAML_JAX ("yaml")
SM2MM_REFERENCE = REPO / "scripts" / "torch_sm2mm_reference.json"
SM2MM_JAX = None
YAML_JAX = None
# the apps phase: a KITTI-format sequence of APPS_FRAMES frames of the street
# drive at HDL-64E geometry (64 rings x 2048 azimuths, 131072 rays a scan,
# 16-byte .bin rows) through the port's command-line entry points
APPS_FRAMES = 40
APPS_RINGS, APPS_AZIMUTHS = 64, 2048
APPS_BATCH = 8  # kitti-odometry -B
APPS_MAP_CAPACITY = 1 << 18  # kitti-odometry --mapping --map-capacity
APPS_DIR = REPO / "chiprun_out" / "apps"
KITTI_YAML = DEMOS / "icp-settings-kitti.yaml"
# FilterEdgesPlanes classifies by ratios of eigenvalues, and the closed-form
# eigh3x3 of the two packages (and of the card and the CPU) differ by up to
# ~7e-5 of the largest eigenvalue where two eigenvalues nearly coincide
# (tests/test_torch_structured_filters.py): a voxel within EIGEN_BAND * l2 of
# a threshold may fall on either side, and only those voxels may differ
EIGEN_BAND = 1e-4
# mm-filter's pipeline: the five structured filters and a ClosestToAverage
# decimation, on frame 0 of the sequence ("raw" with intensity, ring, time)
STRUCTURED_YAML = """
filters:
  - class_name: mp2p_icp_filters::FilterCurvature
    params: {input_pointcloud_layer: raw, output_layer_larger_curvature: curv_larger,
             output_layer_smaller_curvature: curv_smaller, output_layer_other: curv_other}
  - class_name: mp2p_icp_filters::GeneratorEdgesFromCurvature
    params: {input_pointcloud_layer: raw, target_layer: edges_curvature}
  - class_name: mp2p_icp_filters::GeneratorEdgesFromRangeImage
    params: {input_pointcloud_layer: raw, target_layer: edges_range}
  - class_name: mp2p_icp_filters::FilterPoleDetector
    params: {input_pointcloud_layer: raw, output_layer_poles: poles,
             output_layer_no_poles: no_poles, grid_size: 1.0, minimum_relative_height: 1.0}
  - class_name: mp2p_icp_filters::FilterEdgesPlanes
    params: {input_pointcloud_layer: raw, voxel_filter_resolution: 0.5}
  - class_name: mp2p_icp_filters::FilterDecimateVoxels
    params: {input_pointcloud_layer: raw, output_pointcloud_layer: dec_closest,
             voxel_filter_resolution: 0.5, decimate_method: DecimateMethod::ClosestToAverage}
"""
# kitti-odometry's second configuration: icp-settings-kitti.yaml with the
# ground cropped away ahead of its decimation (the returns above
# GROUND_CROP_Z in the sensor frame, FirstPoint at CROPPED_RESOLUTION). The
# demo YAML does not track the street drive (ROADMAP C); this one does, so
# its runs hold the scan-to-scan and scan-to-map paths to the JAX package's
# poses pair by pair
GROUND_CROP_Z = -1.2
CROPPED_RESOLUTION = 1.0
# the frames the constant-velocity guess of a run from rest takes to catch
# up with the drive's 1 m a frame: tracking is judged on the frames after
WARM_FRAMES = 4
# the layers FilterEdgesPlanes writes (their rows may differ on threshold voxels)
EDGES_PLANES_LAYERS = ("edge_points", "plane_points", "plane_centroids")
# the JAX package's results on the CPU for the apps phase: the file that
# `JAX_PLATFORMS=cpu python3 scripts/torch_apps_reference.py --write
# scripts/torch_apps_reference.json` writes; main() reads it into APPS_JAX
APPS_REFERENCE = REPO / "scripts" / "torch_apps_reference.json"
APPS_JAX = None
PARALLEL_REFERENCE = REPO / "scripts" / "torch_parallel_reference.json"
PARALLEL_JAX = None
LOOP_DIR = REPO / "chiprun_out" / "loop"
# the loop-closure phase: an out-and-back drive at HDL-64E geometry through
# kitti-odometry --mapping --loop-closure with the ground-cropped YAML
LOOP_FRAMES = 48
LOOP_MIN_GAP, LOOP_MAX_DISTANCE = 20, 5.0  # kitti-odometry's defaults
# the pose-graph phase: KITTI 00's length (4,541 scans) lapping a circuit
POSE_GRAPH_NODES = 4541
POSE_GRAPH_LAPS = 8
POSE_GRAPH_SMALL = 1000  # the dense solve held against JAX's on the CPU
# CG iterations enough for the dense solve's chi^2 within 1e-4 relative
POSE_GRAPH_CG = {"max_iterations": 10, "cg_iterations": 2000}
# the sharded CG against one rank: fewer CG steps (each is one all-reduce)
POSE_GRAPH_CG_SHARDED = {"max_iterations": 10, "cg_iterations": 200}
SPATIAL_RANKS = 2  # the sharded mapper's and the data-parallel batch's ranks
# the tools phase: rawlog-filter over the apps phase's sequence, sm-filter
# over the sm2mm phase's pass-1 simple map, each with TOOLS_YAML (the
# normals fit on the decimated layer: one K1 k=8 launch per observation)
TOOLS_DIR = REPO / "chiprun_out" / "tools"
TOOLS_YAML = """
generators:
  - class_name: mp2p_icp::Generator
    params: {target_layer: raw}
filters:
  - class_name: mp2p_icp_filters::FilterByRange
    params: {input_pointcloud_layer: raw, output_layer_between: ranged,
             range_min: 2.0, range_max: 60.0}
  - class_name: mp2p_icp_filters::FilterDecimateVoxels
    params: {input_pointcloud_layer: ranged, output_pointcloud_layer: decimated,
             voxel_filter_resolution: 0.5, decimate_method: DecimateMethod::FirstPoint}
  - class_name: mp2p_icp_filters::FilterEstimateNormals
    params: {input_pointcloud_layer: decimated, knn: 8, max_radius: 2.0}
"""
TOOLS_LAYER = "decimated"  # the layer whose normals are held, sm-filter's output
# the georeferencing that mm-georef injects: an anchor near Karlsruhe and a
# T_enu_to_map of a 30 degree yaw and a translation; a fix and a map point
GEOREF = {"latitude": 49.0097, "longitude": 8.4117, "height": 112.0,
          "t_enu_to_map": {"translation": [120.0, -45.0, 3.5],
                           "quaternion_wxyz": [float(np.cos(np.pi / 12)), 0.0, 0.0,
                                               float(np.sin(np.pi / 12))]}}
GEOREF_FIX = "49.0105,8.4130,115.0"
GEOREF_POINT = "25.0,-10.0,1.5"
# nn_search against K1: the grid's cell and the radius^2 of the search (<
# cell^2: every neighbour within it lies in the 27 cells), candidates a cell
NN_GRID_CELL, NN_GRID_RADIUS_SQ, NN_GRID_PER_CELL = 1.0, 0.99, 16
# the share of a frame's normals allowed beyond 1e-3 of the JAX package's
# (ROADMAP C, "closed-form eigen": 4.5% of a decimated street scan)
NORMALS_BAND, NORMALS_SHARE = 1e-3, 0.05
# the JAX package's results on the CPU for the tools phase: the file that
# `JAX_PLATFORMS=cpu python3 scripts/torch_tools_reference.py --write
# scripts/torch_tools_reference.json` writes; main() reads it into TOOLS_JAX
TOOLS_REFERENCE = REPO / "scripts" / "torch_tools_reference.json"
TOOLS_JAX = None


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def pose_of_cpu(mat):
    """A [4, 4] numpy pose on the CPU."""
    return se3.Pose(torch.from_numpy(mat[:3, :3].astype(np.float32)),
                    torch.from_numpy(mat[:3, 3].astype(np.float32)))


def pose_of(mat):
    """A [4, 4] numpy pose on the port's default device."""
    device = default_device()
    return se3.Pose(torch.from_numpy(mat[:3, :3].astype(np.float32)).to(device),
                    torch.from_numpy(mat[:3, 3].astype(np.float32)).to(device))


def engine_icp():
    """The engine phase's 3D configuration: icp-settings-kitti.yaml's
    schedule (bench.py:167-193) with the modules this slice ported."""
    return ICP(
        matchers=[
            MatcherPointsInlierRatio(inliers_ratio=0.8, run_up_to_iteration=5),
            MatcherAdaptive(enable_detect_planes=True, plane_search_points=8,
                            confidence_interval=0.75, first_to_second_distance_max=1.2,
                            absolute_max_search_distance=Expression(ENGINE_AMSD),
                            run_from_iteration=6),
        ],
        solvers=[
            SolverOLAE(run_up_to_iteration=5),
            SolverGaussNewton(run_from_iteration=6, gn_params=GNParams(
                max_iterations=3, kernel=RobustKernel.GEMAN_MCCLURE, kernel_param=0.15)),
            # never solves; reports the scale of the final pairings
            SolverHorn(estimate_scale=True, run_from_iteration=1000),
        ],
        quality_evaluators=[QualityPairedRatio(), QualityVoxels(), QualityRangeImageSimilarity()],
    )


def engine_params(debug_dir=None, hook=None):
    """40 iterations, every iteration and its pairings recorded, a debug
    file per align into ``debug_dir`` (none without one)."""
    return ICPParameters(
        max_iterations=40, record_iterations=True, record_pairings=True, iteration_hook=hook,
        generate_debug_files=debug_dir is not None,
        debug_file_name_format=f"{debug_dir}/engine-$UNIQUE_ID-local-$LOCAL_ID$LOCAL_LABEL-"
                               "global-$GLOBAL_ID$GLOBAL_LABEL.icplog.npz")


def with_voxel_grid(layers, capacity=ENGINE_VOXEL_CAPACITY):
    """``layers`` with a "voxelmap" layer: the "raw" scan inserted into an
    empty grid of ENGINE_VOXEL cells from the sensor at the origin."""
    raw = layers["raw"]
    grid = VoxelGridLayer.empty(capacity, ENGINE_VOXEL, device=raw.device)
    grid = update_voxel_map(grid, raw.xyz, raw.valid_mask(), torch.zeros(3, device=raw.device))
    return dict(layers, voxelmap=grid)


def point2line_icp():
    """demos/icp-settings-2d-lidar-point2line.yaml, built in code."""
    lm = (LayerMatch(global_layer="2d_lidar", local_layer="2d_lidar"),)
    return ICP(
        matchers=[MatcherPoint2Line(distance_threshold=0.25, knn=5, min_points_to_fit=4,
                                    line_eigen_threshold=1e-2, layer_matches=lm),
                  MatcherPointsDistanceThreshold(threshold=0.15, layer_matches=lm)],
        solvers=[SolverGaussNewton(gn_params=GNParams(max_iterations=3))],
        quality_evaluators=[QualityPairedRatio()],
    )


def point2line_params():
    return ICPParameters(max_iterations=100, min_abs_step_trans=1e-4, min_abs_step_rot=1e-4)


def planar_pairs(n_rays=PLANAR_RAYS, n_pairs=PLANAR_PAIRS):
    """[(global scan, local scan, (x, y, yaw) of the local sensor in the
    global sensor's frame)] of planar scans of the street scene at 1 m
    height, numpy [M, 3]: the pair at x = 45 m, then pairs along the drive;
    in each pair the local sensor is 0.3 m ahead and turned by 2°."""
    bearings = np.deg2rad(np.linspace(-135.0, 135.0, n_rays))
    return [(planar_points(g, bearings), planar_points(loc, bearings), rel)
            for g, loc, rel in planar_range_pairs(n_rays, n_pairs)]


def iterations_agree(port, ref, planar=False):
    """The iteration band against the JAX package: ±1, or
    PLANAR_ITERATION_BAND of its count for the 2D demo."""
    return abs(port - ref) <= max(1, PLANAR_ITERATION_BAND * ref if planar else 1)


def pose_of_log(log, device=None):
    """The pose of an SE(3) log (JAX reference constants)."""
    return se3.exp(torch.tensor(log, dtype=torch.float32, device=device))


def planar_guess(rel):
    """The guess of a planar pair as (x, y, z, yaw, pitch, roll): a motion
    model's prediction that falls 20% short of the true motion (6 cm and
    0.4° here). From the identity, the demo's thresholds (0.15 and 0.25 m)
    are below the 0.3 m step, no pair constrains the along-track axis, and
    most pairs stall where they started."""
    return (0.8 * rel[0], 0.8 * rel[1], 0.0, 0.8 * rel[2], 0.0, 0.0)


def planar_layers(scan, n_rays=PLANAR_RAYS):
    """A planar scan as the "2d_lidar" layer of capacity n_rays."""
    return {"2d_lidar": PointCloud.from_numpy(scan, capacity=n_rays)}


def states_equal(a, b):
    """Two voxel-hash map states, tensor for tensor."""
    pairs = [(a.table_k1, b.table_k1), (a.table_k2, b.table_k2), (a.n_dropped, b.n_dropped)]
    pairs += [(getattr(a.pc, f), getattr(b.pc, f))
              for f in ("xyz", "count", "intensity", "ring", "time", "normals")]
    return all((x is None and y is None) or torch.equal(x, y) for x, y in pairs)


def sm2mm_inputs(gt, twists, scans, precise=False, n_keyframes=SM2MM_KEYFRAMES, dt=ODO_DT,
                 box_points=SM2MM_BOX):
    """The simple map of the map-building phase, numpy only (either package
    builds its Keyframes and Observations from it): [(pose [4, 4], twist
    (6 floats), [Observation keyword dicts])]. A keyframe holds its scan's
    returns plus the moving box, in the sensor frame, as a point cloud
    observation at t = dt * i; with ``precise``, first a comment carrying a
    local velocity buffer (the twist's linear velocity at three times) and
    IMU samples of the twist's angular rate over the sweep."""
    rng = np.random.RandomState(21)
    size = np.array([2.0, 2.0, 1.5])
    out = []
    for i in range(n_keyframes):
        T, tw, sc, ts = gt[i], np.asarray(twists[i], np.float64), scans[i], dt * i
        v = sc["valid"]
        # a point on the box's faces, in the world, then in the sensor frame
        u = rng.uniform(-0.5, 0.5, (box_points, 3)) * size
        face = rng.randint(0, 3, box_points)
        u[np.arange(box_points), face] = rng.choice([-0.5, 0.5], box_points) * size[face]
        world = u + (T[0, 3] + 8.0 + 5.0 * i, T[1, 3] + 4.0, 0.75)
        box = ((world - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
        obs = [dict(
            class_name="CObservationPointCloud", sensor_label="lidar", timestamp=ts,
            xyz=np.concatenate([sc["xyz"][v], box]),
            intensity=np.concatenate([sc["intensity"][v], np.full(box_points, 0.5, np.float32)]),
            ring=np.concatenate([sc["ring"][v], np.zeros(box_points, np.float32)]),
            time=np.concatenate([sc["time"][v], rng.uniform(
                -0.5 * dt, 0.5 * dt, box_points).astype(np.float32)]))]
        if precise:
            buffer = {"max_time_window": 1.0, "angular": {},
                      "linear": {str(ts + k * 0.5 * dt): tw[:3].tolist() for k in (-1, 0, 1)}}
            half = int(round(0.5 * dt * IMU_RATE))
            obs = ([dict(class_name="CObservationComment", timestamp=ts,
                         text=yaml.safe_dump({"local_velocity_buffer": buffer}))]
                   + [dict(class_name="CObservationIMU", sensor_label="imu",
                           timestamp=ts + k / IMU_RATE, angular_velocity=tuple(tw[3:].tolist()))
                      for k in range(-half, half + 1)]
                   + obs)
        out.append((T, tuple(tw.tolist()), obs))
    return out


def sm2mm_config(precise):
    """The demo YAML as a dict; ``precise`` turns on the precise deskew in
    memory (the file is not touched)."""
    cfg = yaml.safe_load((DEMOS / "sm2mm_voxelmap_static_dynamic.yaml").read_text())
    if precise:
        for f in cfg["filters"]:
            if f["class_name"].endswith("FilterDeskew"):
                f["params"]["use_precise_local_velocities"] = True
    return cfg


def sm2mm_summary(mm_np):
    """The numbers that the map-building phase compares, from numpy arrays
    of either package's result: ``mm_np`` holds "map_points" (valid rows
    [n, 3]), "static_points" and "dynamic_points" counts, "keys" [C, 3],
    "occupancy" [C], "valid" [C] of the voxel layer, "deskewed" (the last
    keyframe's valid rows)."""
    pts, keys, occ, valid, desk = (mm_np[k] for k in ("map_points", "keys", "occupancy", "valid",
                                                       "deskewed"))
    n_vox = int(valid.sum())
    vi = np.linspace(0, n_vox - 1, SM2MM_SAMPLES).astype(int)
    di = np.linspace(0, len(desk) - 1, SM2MM_SAMPLES).astype(int)
    return {
        "map_points": len(pts), "static": int(mm_np["static_points"]),
        "dynamic": int(mm_np["dynamic_points"]),
        "map_sum": pts.astype(np.float64).sum(0).tolist(),
        "map_abs_sum": np.abs(pts.astype(np.float64)).sum(0).tolist(),
        "voxels": n_vox, "voxel_capacity": len(valid),
        "voxel_key_sum": keys[:n_vox].astype(np.int64).sum(0).tolist(),
        "voxel_occupancy_sum": float(occ[:n_vox].astype(np.float64).sum()),
        "voxel_samples": [[int(i), keys[i].tolist(), float(occ[i])] for i in vi],
        "deskewed_rows": len(desk), "deskewed_mean": desk.astype(np.float64).mean(0).tolist(),
        "deskewed_samples": [[int(i), desk[i].tolist()] for i in di],
    }


def layer_summary(layer):
    """The numbers the YAML phase compares for one output layer, from a
    dict of numpy arrays of either package's layer: a point layer's count,
    float64 coordinate sums and sums of |x| (its scale), its channel sums
    and its rows with a nonzero normal; a 2-D grid's occupancy sum and the
    cells away from 0.5."""
    if "occupancy" in layer:
        g = layer["occupancy"].astype(np.float64)
        return {"cells": int(g.size), "occupancy_sum": float(g.sum()),
                "known": int((g != 0.5).sum())}
    n = int(layer["count"])
    xyz = layer["xyz"][:n].astype(np.float64)
    out = {"count": n, "sum": xyz.sum(0).tolist(), "abs_sum": np.abs(xyz).sum(0).tolist()}
    for ch in ("intensity", "ring", "time"):
        if layer.get(ch) is not None:
            out[f"{ch}_sum"] = float(layer[ch][:n].astype(np.float64).sum())
    if layer.get("normals") is not None:
        out["with_normal"] = int((np.abs(layer["normals"][:n]).sum(1) > 0).sum())
    return out


def mm_filter_summary(mm):
    """``layer_summary`` of each point layer of a map (either package's),
    and its planes' count with float64 sums of the centroids and |normal|."""
    out = {name: layer_summary(arrays) for name, arrays in layers_numpy(mm.layers).items()}
    n = int(mm.planes.count)
    cent, normal = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)[:n].astype(np.float64)
                    for x in (mm.planes.centroid, mm.planes.normal))
    out["planes"] = {"count": n, "centroid_sum": cent.sum(0).tolist(),
                     "centroid_abs_sum": np.abs(cent).sum(0).tolist(),
                     "normal_abs_sum": np.abs(normal).sum(0).tolist()}
    return out


def input_rows(raw_xyz, layer_xyz):
    """[N] bool over the rows of ``raw_xyz`` [N, 3]: the rows of
    ``layer_xyz`` [M, 3], which a compacting filter took from them in input
    order (float32 copies)."""
    def as_bytes(a):
        a = np.ascontiguousarray(a, np.float32)
        return a.view(np.dtype((np.void, 12))).ravel()

    raw, sub = as_bytes(raw_xyz), as_bytes(layer_xyz)
    mask = np.zeros(len(raw), bool)
    j = 0
    for i in range(len(raw)):
        if j < len(sub) and raw[i] == sub[j]:
            mask[i] = True
            j += 1
    check(j == len(sub), f"{len(sub) - j} of {len(sub)} layer rows are not input rows in order")
    return mask


def edges_planes_record(mm, raw_xyz):
    """FilterEdgesPlanes' output in a map (either package's), row for row,
    as base64 text: the input rows of "edge_points" and "plane_points" as
    bit masks over ``raw_xyz`` [N, 3], and the planes' centroids and normals
    as float32 bytes. ``unpack_record`` reads it back."""
    ly = layers_numpy(mm.layers)
    out = {}
    for name in ("edge_points", "plane_points"):
        n = int(ly[name]["count"])
        out[name] = base64.b64encode(np.packbits(input_rows(raw_xyz, ly[name]["xyz"][:n]))
                                     ).decode()
    n = int(mm.planes.count)
    for key in ("centroid", "normal"):
        x = getattr(mm.planes, key)
        x = np.asarray(x.cpu() if hasattr(x, "cpu") else x)[:n]
        out[f"plane_{key}"] = base64.b64encode(x.astype(np.float32).tobytes()).decode()
    return out


def unpack_record(rec, n_raw):
    """``edges_planes_record``'s text as arrays: [n_raw] bool masks and
    [P, 3] float32 rows."""
    def raw_bytes(k):
        return np.frombuffer(base64.b64decode(rec[k]), np.uint8)

    out = {k: np.unpackbits(raw_bytes(k))[:n_raw].astype(bool)
           for k in ("edge_points", "plane_points")}
    out.update({k: raw_bytes(k).view(np.float32).reshape(-1, 3)
                for k in ("plane_centroid", "plane_normal")})
    return out


def write_apps_sequence(out_dir, n_frames=APPS_FRAMES, n_rings=APPS_RINGS,
                        n_azimuth=APPS_AZIMUTHS):
    """The apps phase's KITTI-format sequence, numpy only: the street drive
    (``make_street_sequence``) as ``out_dir/velodyne/%06d.bin`` (the returns
    of each scan, float32 x y z intensity) and ``out_dir/gt.txt`` (the true
    poses relative to frame 0, KITTI format). Returns (velodyne dir, gt
    path, scans)."""
    from mp2p_icp_tpu_torch.eval.trajectory import save_kitti_poses

    gt, _, scans = make_street_sequence(n_frames, n_rings=n_rings, n_azimuth=n_azimuth)
    out_dir = pathlib.Path(out_dir)
    bin_dir = out_dir / "velodyne"
    bin_dir.mkdir(parents=True, exist_ok=True)
    for i, sc in enumerate(scans):
        v = sc["valid"]
        rows = np.concatenate([sc["xyz"][v], sc["intensity"][v][:, None]], axis=1)
        rows.astype(np.float32).tofile(bin_dir / f"{i:06d}.bin")
    save_kitti_poses(out_dir / "gt.txt", np.linalg.inv(gt[0]) @ gt)
    return bin_dir, out_dir / "gt.txt", scans


def loop_drive(n_frames=LOOP_FRAMES, dt=ODO_DT, speed=10.0):
    """The street drive out and back along one line: x(i) = 12 + D sin(pi
    i / (n - 1)), out at ``speed`` to a stop at the middle frame and back
    to the start at ``speed`` (D = speed dt (n - 1) / pi), the lateral
    weave and the yaw of ``make_street_sequence`` as functions of x, so
    that frame n - 1 - i stands where frame i stood. Returns (gt [N, 4, 4]
    float64 poses, twists: N float32 [6] true body twists), numpy, made
    with the port's se3 on the CPU."""
    D = speed * dt * (n_frames - 1) / np.pi
    xs = 12.0 + D * np.sin(np.pi * np.arange(n_frames) / (n_frames - 1))
    poses = [se3.from_xyz_ypr(x, 0.5 * np.sin(0.15 * (x - 12.0)), 1.7,
                              0.05 * np.sin(0.2 * (x - 12.0)), 0.0, 0.0, device="cpu")
             for x in xs]
    twists = [np.asarray(se3.log(se3.compose(se3.inverse(a), b)).numpy() / dt, np.float32)
              for a, b in zip(poses[:-1], poses[1:])]
    twists.append(twists[-1])
    gt = np.tile(np.eye(4), (n_frames, 1, 1))
    gt[:, :3, :3] = torch.stack([p.R for p in poses]).numpy()
    gt[:, :3, 3] = torch.stack([p.t for p in poses]).numpy()
    return gt, twists


def write_loop_sequence(out_dir, n_frames=LOOP_FRAMES, n_rings=APPS_RINGS,
                        n_azimuth=APPS_AZIMUTHS):
    """``loop_drive`` rendered in the street of ``make_street_sequence``
    (the same scene and random stream) as a KITTI-format sequence, like
    ``write_apps_sequence``. Returns (velodyne dir, gt path, gt poses)."""
    from mp2p_icp_tpu_torch.eval.trajectory import save_kitti_poses

    gt, twists = loop_drive(n_frames)
    rng = np.random.RandomState(7)
    scene = make_street_scene(rng, length=260.0, n_pillars=60)
    out_dir = pathlib.Path(out_dir)
    bin_dir = out_dir / "velodyne"
    bin_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n_frames):
        sc = render_spinning_scan(scene, pose_of_cpu(gt[i]), twists[i], rng,
                                  n_rings=n_rings, n_azimuth=n_azimuth)
        v = sc["valid"]
        rows = np.concatenate([sc["xyz"][v], sc["intensity"][v][:, None]], axis=1)
        rows.astype(np.float32).tofile(bin_dir / f"{i:06d}.bin")
    save_kitti_poses(out_dir / "gt.txt", np.linalg.inv(gt[0]) @ gt)
    return bin_dir, out_dir / "gt.txt", np.linalg.inv(gt[0]) @ gt


def lap_graph(n_nodes=POSE_GRAPH_NODES, laps=POSE_GRAPH_LAPS, radius=75.0, loop_every=10,
              seed=0):
    """A pose graph whose trajectory laps a circuit ``laps`` times: node k
    on a circle of ``radius`` m at the angle 2 pi k / per (per = the nodes
    of a lap, so node k + per stands where node k stood), heading along it.
    Odometry edges k -> k + 1 measured with noise (sigma 0.01 m and 0.001
    rad per axis), loop edges from every ``loop_every``-th node to the node
    one lap later (sigma 0.02 m, 0.002 rad), each with the information of
    its noise, diag(1 / sigma^2); the initial guess integrates the noisy
    odometry (it drifts).
    numpy only (the port's se3 on the CPU, float64). Returns (gt [N, 4, 4],
    init [N, 4, 4], edges {i, j, z_R, z_t, information, valid})."""
    rng = np.random.RandomState(seed)
    per = -(-n_nodes // laps)
    ang = 2.0 * np.pi * np.arange(n_nodes) / per
    gt = np.tile(np.eye(4), (n_nodes, 1, 1))
    c, s_ = np.cos(ang + np.pi / 2), np.sin(ang + np.pi / 2)
    gt[:, 0, 0], gt[:, 0, 1], gt[:, 1, 0], gt[:, 1, 1] = c, -s_, s_, c
    gt[:, 0, 3], gt[:, 1, 3] = radius * np.cos(ang), radius * np.sin(ang)

    def noisy(rel, sigma_t, sigma_r):
        xi = np.concatenate([rng.randn(len(rel), 3) * sigma_t, rng.randn(len(rel), 3) * sigma_r],
                            axis=1)
        e = se3.exp(torch.from_numpy(xi))
        n = np.tile(np.eye(4), (len(rel), 1, 1))
        n[:, :3, :3], n[:, :3, 3] = e.R.numpy(), e.t.numpy()
        return rel @ n

    inv = np.linalg.inv(gt)
    odo = noisy(inv[:-1] @ gt[1:], 0.01, 0.001)
    li = np.arange(0, n_nodes - per, loop_every)
    loop = noisy(inv[li] @ gt[li + per], 0.02, 0.002)
    init = np.tile(np.eye(4), (n_nodes, 1, 1))
    init[0] = gt[0]
    for k in range(1, n_nodes):
        init[k] = init[k - 1] @ odo[k - 1]
    z = np.concatenate([odo, loop])
    info = np.concatenate([np.tile([1e4] * 3 + [1e6] * 3, (n_nodes - 1, 1)),
                           np.tile([2.5e3] * 3 + [2.5e5] * 3, (len(li), 1))])
    edges = {"i": np.concatenate([np.arange(n_nodes - 1), li]),
             "j": np.concatenate([np.arange(1, n_nodes), li + per]),
             "z_R": z[:, :3, :3].astype(np.float32), "z_t": z[:, :3, 3].astype(np.float32),
             "information": (np.eye(6)[None] * info[:, None, :]).astype(np.float32),
             "valid": np.ones(len(z), bool)}
    return gt, init, edges


def pad_edges(edges, multiple):
    """The edges padded with invalid ones (node 0 to 0, identity) to a
    multiple of ``multiple`` rows, as a sharded solve needs."""
    pad = (-len(edges["i"])) % multiple
    fill = {"i": np.zeros(pad, np.int64), "j": np.zeros(pad, np.int64),
            "z_R": np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1)),
            "z_t": np.zeros((pad, 3), np.float32),
            "information": np.tile(np.eye(6, dtype=np.float32), (pad, 1, 1)),
            "valid": np.zeros(pad, bool)}
    return {k: np.concatenate([np.asarray(v), fill[k].astype(np.asarray(v).dtype)])
            for k, v in edges.items()}


def ground_cropped_yaml():
    """icp-settings-kitti.yaml with a FilterBoundingBox ahead of its
    decimation that keeps the returns above GROUND_CROP_Z (sensor frame),
    decimated at CROPPED_RESOLUTION: YAML text."""
    cfg = yaml.safe_load(KITTI_YAML.read_text())
    cfg["filters"][0]["params"].update(input_pointcloud_layer="above",
                                       voxel_filter_resolution=CROPPED_RESOLUTION)
    cfg["filters"].insert(0, {"class_name": "mp2p_icp_filters::FilterBoundingBox", "params": {
        "input_pointcloud_layer": "raw", "inside_pointcloud_layer": "above",
        "bounding_box_min": [-1.0e3, -1.0e3, GROUND_CROP_Z],
        "bounding_box_max": [1.0e3, 1.0e3, 1.0e3]}})
    return yaml.safe_dump(cfg, sort_keys=False)


def write_app_inputs(out_dir, scans):
    """The files icp-run and mm-filter read, written by the port's writers
    on the CPU: frames 0 and 1 as .xyz.gz and as MRPT binary .mm (their
    returns with intensity, ring and time: CPointsMapXYZIRT), frame 0 as
    .mm.npz, mm-filter's YAML and ``ground_cropped_yaml``. Returns {name:
    path}."""
    from mp2p_icp_tpu_torch.core.metric_map import MetricMap
    from mp2p_icp_tpu_torch.io.mm import save_mm_file
    from mp2p_icp_tpu_torch.io.mrpt_mm import save_mrpt_mm
    from mp2p_icp_tpu_torch.io.xyz import save_xyz_file

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for i in (0, 1):
        pc = scan_to_pointcloud(scans[i], device="cpu")
        paths[f"xyz{i}"] = out_dir / f"frame{i}.xyz.gz"
        paths[f"mm{i}"] = out_dir / f"frame{i}.mm"
        save_xyz_file(paths[f"xyz{i}"], pc)
        save_mrpt_mm(MetricMap(layers={"raw": pc}), paths[f"mm{i}"])
        if i == 0:
            paths["npz0"] = out_dir / "frame0.mm.npz"
            save_mm_file(paths["npz0"], MetricMap(layers={"raw": pc}))
    paths["filters"] = out_dir / "structured.yaml"
    paths["filters"].write_text(STRUCTURED_YAML)
    paths["cropped"] = out_dir / "icp-settings-kitti-cropped.yaml"
    paths["cropped"].write_text(ground_cropped_yaml())
    return {k: str(v) for k, v in paths.items()}


def write_rawlog(path, scans, imu_first=False):
    """The scans' returns as a ``.rawlog.npz`` (the port's writer, on the
    CPU), one point-cloud observation each (xyz, intensity, ring, time) at
    t = ODO_DT * i; with ``imu_first`` an IMU observation (no generator
    handles it) leads."""
    from mp2p_icp_tpu_torch.filters.generator import Observation
    from mp2p_icp_tpu_torch.io.rawlog import Rawlog

    rl = Rawlog()
    if imu_first:
        rl.append(Observation(class_name="CObservationIMU", sensor_label="imu",
                              timestamp=-ODO_DT, angular_velocity=(0.0, 0.0, 0.1)))
    for i, sc in enumerate(scans):
        v = sc["valid"]
        rl.append(Observation(class_name="CObservationPointCloud", sensor_label="lidar",
                              timestamp=ODO_DT * i, xyz=sc["xyz"][v],
                              intensity=sc["intensity"][v], ring=sc["ring"][v],
                              time=sc["time"][v]))
    rl.save(str(path))
    return path


def observation_summary(obs):
    """The numbers the tools phase compares for one observation of either
    package: label, rows, float64 coordinate sums and |x| sums, channel
    sums."""
    xyz = np.asarray(obs.xyz, np.float64).reshape(-1, 3)
    out = {"label": obs.sensor_label, "count": int(xyz.shape[0]), "sum": xyz.sum(0).tolist(),
           "abs_sum": np.abs(xyz).sum(0).tolist()}
    for ch in ("intensity", "ring", "time"):
        v = getattr(obs, ch)
        if v is not None:
            out[f"{ch}_sum"] = float(np.asarray(v, np.float64).sum())
    return out


def rawlog_summary(rl):
    """[frame: [observation_summary of each entry]] of either package's
    Rawlog (the entries of a frame share its id)."""
    frames = {}
    for obs, f in zip(rl.observations, rl.frames):
        frames.setdefault(f, []).append(observation_summary(obs))
    return [frames[f] for f in sorted(frames)]


@contextlib.contextmanager
def captured_layers(filters_module, record, layer=TOOLS_LAYER):
    """``filters_module.apply_filter_pipeline`` (either package's
    ``filters``) wrapped so that every run appends its ``layer`` (xyz,
    count, normals as numpy) to ``record``: rawlog-filter writes no
    normals, and these are the ones its run fitted."""
    run = filters_module.apply_filter_pipeline

    def recording(filters, mm, variables=None):
        out = run(filters, mm, variables)
        pc = (out.layers if hasattr(out, "layers") else out).get(layer)
        if pc is not None:
            record.append({k: np.asarray(v.cpu() if hasattr(v, "cpu") else v) for k, v in (
                ("xyz", pc.xyz), ("count", pc.count), ("normals", pc.normals))})
        return out

    filters_module.apply_filter_pipeline = recording
    try:
        yield record
    finally:
        filters_module.apply_filter_pipeline = run


def normals_summary(layer):
    """A fitted layer's rows with a normal and float64 sums of |n| (sign
    free), from ``captured_layers``' numpy dict."""
    n = int(layer["count"])
    nrm = layer["normals"][:n].astype(np.float64)
    return {"count": n, "with_normal": int((np.abs(nrm).sum(1) > 0).sum()),
            "normal_abs_sum": np.abs(nrm).sum(0).tolist()}


def pack_normals(normals):
    """[n, 3] unit normals as int16 (x 32767, zlib, base64): 1.5e-5 steps."""
    import zlib

    q = np.round(np.asarray(normals, np.float64) * 32767).astype("<i2")
    return base64.b64encode(zlib.compress(q.tobytes(), 9)).decode("ascii")


def unpack_normals(text):
    import zlib

    return (np.frombuffer(zlib.decompress(base64.b64decode(text)), "<i2").reshape(-1, 3)
            .astype(np.float64) / 32767)


def normals_beyond_band(got, want, band=NORMALS_BAND):
    """[n] bool: rows whose normal is more than ``band`` from the
    reference's (up to 1.5e-5 of packing), up to sign."""
    got = np.asarray(got, np.float64)
    d = np.minimum(np.abs(got - want).max(1), np.abs(got + want).max(1))
    return d > band + 2e-5


def simplemap_summary(sm):
    """The point rows of each keyframe of either package's SimpleMap."""
    return [sum(int(np.asarray(o.xyz).shape[0]) for o in kf.observations
                if o.xyz is not None) for kf in sm.keyframes]


def tools_inputs_frame0(scan, out_dir):
    """Frame 0 for the converters: ``frame0.txt`` (x y z intensity ring
    time, %.6f) and ``frame0.bin`` (KITTI rows). Returns the two paths."""
    v = scan["valid"]
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    txt, bin_ = out_dir / "frame0.txt", out_dir / "frame0.bin"
    np.savetxt(txt, np.column_stack([scan["xyz"][v], scan["intensity"][v], scan["ring"][v],
                                     scan["time"][v]]), fmt="%.6f")
    np.concatenate([scan["xyz"][v], scan["intensity"][v][:, None]], 1).astype(
        np.float32).tofile(bin_)
    return txt, bin_

def icp_run_printed(text):
    """{"t", "quat" (wxyz), "iterations", "termination", "quality",
    "pairings"} from icp-run's printed results (either package's)."""
    def grab(key):
        return re.search(rf"{key}\s*: (.*)", text).group(1).strip()

    return {"t": json.loads(grab("translation")), "quat": json.loads(grab(r"quat \(wxyz\)")),
            "iterations": int(grab("iterations")), "termination": grab("termination"),
            "quality": float(grab("quality")), "pairings": int(grab("pairings"))}


def kitti_odometry_printed(text):
    """{"scans_per_s", "iterations" (total), "batch_iterations"} from
    kitti-odometry's printed lines."""
    out = {"scans_per_s": float(re.search(r"scans/s=([0-9.]+)", text).group(1)),
           "iterations": int(re.search(r"ICP iterations: (\d+)", text).group(1))}
    batches = re.search(r"the slowest pair of each batch: (\[.*\])", text)
    out["batch_iterations"] = json.loads(batches.group(1)) if batches else []
    return out


def trajectory_errors(poses, gt):
    """(ATE RMSE, RPE translation, RPE rotation) of [N, 4, 4] poses."""
    from mp2p_icp_tpu_torch.eval.trajectory import rpe

    rt, rr = rpe(poses, gt[: len(poses)])
    return ate_rmse(poses, gt[: len(poses)]), float(rt), float(rr)


def pair_gaps(a, b):
    """[N-1] gaps between the relative poses of two [N, 4, 4] trajectories,
    frame to frame: sqrt(|dt|^2 + angle^2) of inv(rel_b) rel_a."""
    out = []
    for i in range(1, len(a)):
        d = np.linalg.inv(np.linalg.inv(b[i - 1]) @ b[i]) @ (np.linalg.inv(a[i - 1]) @ a[i])
        angle = np.arccos(np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))
        out.append(float(np.hypot(np.linalg.norm(d[:3, 3]), angle)))
    return np.asarray(out)


def kitti_rows_to_poses(rows):
    """[N, 4, 4] of KITTI pose rows [N, 12]."""
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3, :] = np.asarray(rows, np.float64).reshape(-1, 3, 4)
    return poses


def edges_planes_threshold_voxels(f, pc, band=EIGEN_BAND):
    """The voxels of FilterEdgesPlanes ``f`` on cloud ``pc`` whose class
    could flip under an eigenvalue error of ``band`` * l2 (a ratio test
    e_a > c * e0 within (1 + c) * band * l2 of its threshold, e1 within
    band * l2 of min_e1, or |n_z| within the normal's first-order error of
    the 0.9 of the horizontal test). Returns (near [C] bool over the voxel
    segments, well [C] bool: a voxel whose normal moves by < 1e-3 under
    that error and does not face the sensor edge-on, count [C], the voxel
    segments)."""
    segs, cnt, mean, evals, n, _, _ = f.classify(pc)
    e0, e1, e2 = evals[:, 0], evals[:, 1], evals[:, 2]
    d = band * torch.abs(e2)
    near = torch.abs(e1 - f.voxel_filter_min_e1) <= d
    for ea, c in ((e2, f.voxel_filter_max_e2_e0), (e1, f.voxel_filter_max_e1_e0),
                  (e2, f.voxel_filter_min_e2_e0), (e1, f.voxel_filter_min_e1_e0)):
        near |= torch.abs(ea - c * e0) <= (1.0 + c) * d
    sens = d / torch.clamp(e1 - e0, min=1e-30)
    u = mean / torch.clamp(torch.linalg.vector_norm(mean, dim=1, keepdim=True), min=1e-9)
    facing = torch.abs(torch.sum(u * n, dim=1))
    near |= torch.abs(torch.abs(n[:, 2]) - 0.9) <= sens + 1e-6
    well = (sens < 1e-3) & (facing > 1e-2)
    return near & (cnt >= f.min_points_per_voxel), well, cnt, segs


def voxel_rows(segs, voxels):
    """[C] bool in input order: the rows of the voxel segments ``voxels``."""
    rows = segs.valid & voxels[segs.segment_id]
    return torch.zeros_like(rows).scatter(0, segs.order, rows)


def held_edges_planes(f, raw, mm, want, where):
    """Holds FilterEdgesPlanes ``f``'s output in the port's map ``mm`` (made
    from the cloud ``raw``) to the JAX package's ``edges_planes_record``
    ``want``, row for row: a row of "edge_points" or "plane_points", and a
    plane, may differ only in a threshold voxel
    (``edges_planes_threshold_voxels``); a plane both call a plane has its
    centroid within 1e-5 of JAX's and its normal within 1e-4 where well
    conditioned, else within its conditioning bound. Prints what differs.
    Returns (threshold voxels, their rows)."""
    near, well, cnt, segs = edges_planes_threshold_voxels(f, raw)
    _, _, mean, evals, _, _, is_plane = f.classify(raw)
    n_raw = int(raw.count)
    xyz = raw.xyz[:n_raw].cpu().numpy()
    near_rows = voxel_rows(segs, near)[:n_raw].cpu().numpy()
    got, ref = (unpack_record(r, n_raw) for r in (edges_planes_record(mm, xyz), want))
    for name in ("edge_points", "plane_points"):
        differ = got[name] ^ ref[name]
        print(f"[apps] mm-filter {name}: {int(got[name].sum())} rows "
              f"[JAX {int(ref[name].sum())}], {int(differ.sum())} differ, all in threshold "
              f"voxels: {not (differ & ~near_rows).any()}")
        check(not (differ & ~near_rows).any(), f"{where}: {int((differ & ~near_rows).sum())} "
              f"{name} rows off the threshold voxels differ from the JAX package's")
    # the planes, in the order of the voxel segments the filter calls planes
    dev = mean.device
    plane_vox = torch.nonzero(is_plane).flatten()
    tc, tn, jc, jn = (torch.from_numpy(np.array(a)).to(dev) for a in (
        got["plane_centroid"], got["plane_normal"], ref["plane_centroid"], ref["plane_normal"]))
    check(torch.equal(tc, mean[plane_vox]), f"{where}: the planes are not the classified voxels")
    check(np.array_equal(layers_numpy(mm.layers)["plane_centroids"]["xyz"][: len(tc)],
                         got["plane_centroid"]),
          f"{where}: plane_centroids is not the planes' centroids")
    d = torch.cdist(tc[None].double(), jc[None].double(), p=float("inf"))[0]
    t_gap, t_to = d.min(dim=1)
    j_gap = d.min(dim=0).values
    t_off = t_gap > 1e-5
    check(bool(near[plane_vox[t_off]].all()), f"{where}: a plane that JAX lacks is off the "
          f"threshold voxels")
    # a JAX plane the port lacks: the voxel whose mean it is must be a threshold voxel
    enough = torch.nonzero(cnt >= f.min_points_per_voxel).flatten()
    j_off = torch.nonzero(j_gap > 1e-5).flatten()
    if len(j_off):
        dv = torch.cdist(jc[j_off][None].double(), mean[enough][None].double(),
                         p=float("inf"))[0]
        gap_v, v = dv.min(dim=1)
        check(bool((gap_v <= 1e-5).all()) and bool(near[enough[v]].all()),
              f"{where}: a JAX plane that the port lacks is off the threshold voxels")
    # normals: within 1e-4 where well conditioned; elsewhere, up to the
    # sign, within the first-order error an eigenvalue error of
    # EIGEN_BAND * l2 makes (EIGEN_BAND * l2 / (l1 - l0))
    matched = torch.nonzero(~t_off).flatten()
    v = plane_vox[matched]
    a, b = tn[matched], jn[t_to[matched]]
    gap = (a - b).abs().amax(dim=1)
    gap_any_sign = torch.minimum(gap, (a + b).abs().amax(dim=1))
    sens = EIGEN_BAND * evals[v, 2].abs() / torch.clamp(evals[v, 1] - evals[v, 0], min=1e-30)
    well_m = well[v]
    well_gap = float(gap[well_m].max()) if bool(well_m.any()) else 0.0
    excess = float((gap_any_sign - 2.0 * sens).max()) if len(v) else 0.0
    print(f"[apps] mm-filter planes: {len(tc)} [JAX {len(jc)}], {len(matched)} matched "
          f"(centroids within {float(t_gap[matched].max()) if len(matched) else 0.0:.3g}), "
          f"{int(t_off.sum())} only the port's and {len(j_off)} only JAX's, all in threshold "
          f"voxels; normals: {int(well_m.sum())} well conditioned within {well_gap:.3g}, the "
          f"other {int((~well_m).sum())} up to the sign within 1e-4 of twice their "
          f"conditioning bound (largest excess {excess:.3g})")
    check(well_gap <= 1e-4 and excess <= 1e-4,
          f"{where}: plane normals {well_gap} (well conditioned) and {excess} beyond the "
          f"conditioning bound from JAX's")
    return int(near.sum()), int(cnt[near].sum())


def example1_pair(scene, n=N_POINTS):
    """(local scan, global scan) numpy [n, 3] of the example1 demo."""
    g = sample_scan(scene, np.random.RandomState(2), n=n) / EXAMPLE1_SCALE
    gt = se3.from_xyz_ypr(*EXAMPLE1_GT, device="cpu")
    return se3.apply(se3.inverse(gt), torch.from_numpy(g)).numpy(), g


def sentinel_padded(pc, far):
    """A layer's rows as the kNN front end gives them to a sweep: valid rows,
    then ``far`` (queries +1e8, points -1e8)."""
    return torch.where(pc.valid_mask()[:, None], pc.xyz, far).contiguous()


def generated_2d_layer(ranges):
    """The 2D demo generator's "2d_lidar" layer of a planar range scan."""
    from mp2p_icp_tpu_torch.core.metric_map import MetricMap
    from mp2p_icp_tpu_torch.filters.generator import Observation
    from mp2p_icp_tpu_torch.pipeline import load_icp_config_file

    mm = MetricMap()
    gens = load_icp_config_file(DEMOS / "icp-settings-2d-lidar-point2line.yaml")[2]["generators"]
    for g in gens:
        g.process(Observation(**planar_observation(ranges)), mm)
    return mm.layers["2d_lidar"]


def yaml_pipeline_input_layer(scan):
    """The layer whose normals ALL_FILTERS_YAML fits, "dec_first" (one
    street frame's returns within 3-30 m, FirstPoint-decimated at 0.5 m,
    capacity 2^16), as the pipeline makes it."""
    from mp2p_icp_tpu_torch.filters import apply_filter_pipeline
    from mp2p_icp_tpu_torch.pipeline import filter_pipeline_from_yaml

    filters = filter_pipeline_from_yaml(yaml.safe_load(ALL_FILTERS_YAML)["filters"])
    return apply_filter_pipeline(
        filters, {"raw": scan_to_pointcloud(scan, capacity=1 << 16)})["dec_first"]


def same_modules(a, b, layers=None):
    """Two ICPs equal config for config (``convert.config_of``): matchers,
    solvers, quality evaluators and weights; ``layers`` renames the layers
    of a's matchers first ({a's name: b's name})."""
    from mp2p_icp_tpu_torch import convert

    def renamed(m):
        if not layers or not hasattr(m, "layer_matches"):
            return m
        return dataclasses.replace(m, layer_matches=tuple(dataclasses.replace(
            lm, global_layer=layers.get(lm.global_layer, lm.global_layer),
            local_layer=layers.get(lm.local_layer, lm.local_layer)) for lm in m.layer_matches))

    return ([convert.config_of(renamed(m)) for m in (*a.matchers, *a.solvers,
                                                     *a.quality_evaluators)]
            == [convert.config_of(m) for m in (*b.matchers, *b.solvers, *b.quality_evaluators)]
            and list(a.quality_weights) == list(b.quality_weights))


def planar_observation(ranges):
    """A planar scan's ranges as CObservation2DRangeScan keywords (270°)."""
    return dict(class_name="CObservation2DRangeScan", sensor_label="hokuyo",
                scan_ranges=np.asarray(ranges, np.float32), aperture=float(np.deg2rad(270.0)),
                max_range=30.0)


def planar_range_pairs(n_rays=PLANAR_RAYS, n_pairs=PLANAR_PAIRS):
    """The planar pairs as ranges (0: no return): [(global ranges, local
    ranges, rel)] (``planar_pairs`` gives their points)."""
    scene = make_street_scene(np.random.RandomState(0))
    rng = np.random.RandomState(40)
    out = []
    for i in range(n_pairs):
        x, y, yaw = (45.0, 0.0, 0.0) if i == 0 else (
            20.0 + 20.0 * (i - 1), rng.uniform(-0.5, 0.5), rng.uniform(-0.1, 0.1))
        g, _ = render_planar_ranges(scene, x, y, yaw, np.random.RandomState(100 + 2 * i),
                                    n_rays=n_rays)
        x2, y2, yaw2 = x + 0.3 * np.cos(yaw), y + 0.3 * np.sin(yaw), yaw + np.deg2rad(2.0)
        loc, _ = render_planar_ranges(scene, x2, y2, yaw2, np.random.RandomState(101 + 2 * i),
                                      n_rays=n_rays)
        c, s_ = np.cos(yaw), np.sin(yaw)
        out.append((g, loc, (c * (x2 - x) + s_ * (y2 - y), -s_ * (x2 - x) + c * (y2 - y),
                             yaw2 - yaw)))
    return out


def reset_counts():
    cuda_build.reset_launches()


def counts():
    return dict(cuda_build.launches)


def knn_launches(n):
    """The kNN sweeps' launches in a ``counts()`` dict."""
    return sum(v for name, v in n.items() if name.startswith("knn_"))


def count_own(launches, by_path, n, label):
    """Adds the launches of the port's own kernels (``REPLACES`` None) in
    one path's counted window (``n``: its ``counts()``, or one per rank) to
    ``launches`` and ``by_path``. The Gauss-Newton kernel's are 0 where the
    path's solves took the plain path (a robust kernel, a prior, or pt2ln /
    ln2ln / pl2pl pairs); the termination kernel's are one per ICP
    iteration of an align on the card (a batched align's: one per
    iteration of the batch)."""
    for name in (name for name, jax in REPLACES.items() if jax is None):
        per = [r[name] for r in n] if isinstance(n, list) else n[name]
        launches[name] += sum(per) if isinstance(per, list) else per
        by_path[name][label] = per


def matcher_calls(icp, n_iterations):
    """kNN sweeps the ICP loop ran: one per active matcher and layer pair
    on each iteration (the paired-ratio quality reuses the ICP pairings)."""
    return sum(
        len(m.layer_matches)
        for it in range(n_iterations) for m in icp.matchers if m.gate(it) > 0
    )


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, replays=7, calls=GRAPH_LAUNCHES):
    """Device milliseconds per call of fn(): a CUDA graph of ``calls`` calls
    (so no host gaps between the launches), the times of `replays` replays
    by CUDA events, each divided by the calls."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def library_ms(q, p, k):
    """Device ms of the one PyTorch call that computes the kNN, up to ties
    (it keeps no index order): torch.cdist + topk(k, largest=False) at the
    row's shape, a shared map broadcast over the batch, in a CUDA graph (2
    calls where the Q x C distance matrix passes 2^30 entries)."""
    if q.ndim == 3 and p.ndim == 2:
        p = p.expand(q.shape[0], -1, -1)

    def call():
        return torch.cdist(q, p).topk(k, dim=-1, largest=False)

    big = q.numel() // 3 * p.shape[-2] > 1 << 30
    ms = statistics.median(graph_ms(call, replays=3 if big else 7,
                                    calls=2 if big else GRAPH_LAUNCHES))
    torch.cuda.empty_cache()
    return ms


def library_slabs_ms(q, p, k, slab=8192):
    """Device ms of cdist + topk over query slabs of ``slab`` rows, one
    slab after another between CUDA events (median of 3): the library
    call where the whole [Q, C] distance matrix would not fit on the card."""
    qs = q if q.ndim == 3 else q[None]
    ps = p if p.ndim == 3 else p[None].expand(qs.shape[0], -1, -1)

    def call():
        for b in range(qs.shape[0]):
            for s in range(0, qs.shape[1], slab):
                torch.cdist(qs[b, s:s + slab], ps[b]).topk(k, dim=-1, largest=False)

    ms = cuda_ms(call, reps=3, warmup=1)
    torch.cuda.empty_cache()
    return ms


def kernel_row(name, label, B, Q, C, k, run, plain, lq, lp, g_times, smi, plain_reps=3,
               counts=None):
    """A kernel's line of the results: its device time per launch in a
    CUDA graph (the median of ``g_times``), one call between events, its
    bound from the valid rows and over every row swept (the leading rows of
    ``counts`` = (query counts, point counts) where the call passes them,
    else every row), its plain version's time (the median of
    ``plain_reps`` calls after one warm-up) and the library call's (in query
    slabs where the [Q, C] matrix passes 2^32 entries); printed."""
    bnd, by = data_bound_ms(lq, lp, k)
    nq, npt = swept_rows(B, Q, C, counts)
    swept, _ = work_bound_ms(sum(a * b for a, b in zip(nq, npt)), sum(nq), sum(npt), k)
    ms = statistics.median(g_times)
    slabs = B * Q * C > 1 << 32
    row = {"shape": f"{B}x{Q}x{C}", "k": k, "what": label, "ms": ms,
           "call_ms": cuda_ms(run, reps=5 if slabs else 20), "bound_ms": bnd, "bound_by": by,
           "share_of_bound": bnd / ms, "swept_bound_ms": swept,
           "swept_queries": sum(nq), "swept_points": sum(npt),
           "plain_ms": cuda_ms(plain, reps=plain_reps, warmup=1),
           "library_ms": library_slabs_ms(lq, lp, k) if slabs else library_ms(lq, lp, k)}
    print(f"[time] {name} {label} {B}x{Q}x{C} k={k}: {ms:.4f} ms per launch in a CUDA "
          f"graph, {row['call_ms']:.4f} ms for one call between events; bound {bnd:.6f} ms "
          f"({by}, the valid rows), share {bnd / ms:.3%}; swept rows {sum(nq)} x "
          f"{sum(npt)} of {B * Q} x {B * C}{'' if counts else ' (every row)'}, their bound "
          f"{swept:.6f} ms, share {swept / ms:.1%}; plain {row['plain_ms']:.4f} ms; "
          f"library cdist + topk "
          f"{row['library_ms']:.4f} ms "
          f"{'over query slabs of 8192 rows' if slabs else 'in a CUDA graph'} on {smi}")
    return row


# the Gauss-Newton kernel (csrc/gn_solve.cu) at the cells' shapes: (label,
# problems, pt2pt rows, pt2pl rows)
GN_SHAPES = (("stream: 1 x 6144 pt2pl", 1, 0, 6144),
             ("scan: 1 x 8192 pt2pt", 1, 8192, 0),
             ("fleet: 8 x 6144 pt2pl", 8, 0, 6144))
GN_FLOPS = {"pt2pt": 90, "pt2pl": 115}  # float64 operations a row an inner step (gn_solve.cu)
GN_BYTES = {"pt2pt": 28, "pt2pl": 40}  # float32 bytes a row
FP64_TFLOPS = 34.0  # H100 SXM, float64 outside the tensor cores
HBM_TBS = 3.35
N_SMS = 132


def gn_bounds_us(B, n_pt, n_pl, iterations):
    """The fused solve's bounds in us: (the card's: float64 operations over
    its peak, or each input byte read once over its bandwidth, whichever is
    larger; "operations" or "bytes", the one that sets it; one SM's: the
    operations of one problem over 1/132 of the peak, a problem being one
    block)."""
    flops = iterations * (n_pt * GN_FLOPS["pt2pt"] + n_pl * GN_FLOPS["pt2pl"])
    bytes_ = B * (n_pt * GN_BYTES["pt2pt"] + n_pl * GN_BYTES["pt2pl"])
    ops_us, bytes_us = B * flops / (FP64_TFLOPS * 1e6), bytes_ / (HBM_TBS * 1e6)
    return (max(ops_us, bytes_us), "operations" if ops_us >= bytes_us else "bytes",
            flops / (FP64_TFLOPS * 1e6 / N_SMS))


def gn_phase(smi):
    """The Gauss-Newton kernel at the cells' shapes: its build, each
    problem's pose against the plain float64 path's (within 1 float32 ulp:
    the two sum in different orders), then its device time per call in a
    CUDA graph of 20 calls, one call between CUDA events, its bounds and
    the plain path's time (one call between events: ~400 small kernels an
    inner iteration, issued from Python). The problems are
    ``eval.gn_problem``'s, seeds 170 on. Returns (rows, the largest |pose
    - plain pose| of each shape)."""
    cuda_build.load_library("gn_solve")
    rec = cuda_build.build_record("gn_solve")
    for line in rec["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[gn] build: {line.strip().removeprefix('ptxas info    : ')}")
    params = GNParams(max_iterations=3)
    rows, errs, seed = [], [], 170
    for label, B, n_pt, n_pl in GN_SHAPES:
        problems = [gn_problem(seed + b, n_pt, n_pl, device="cuda") for b in range(B)]
        seed += B
        if B == 1:
            (pairings, guess), = problems

            def fused():
                return gauss_newton.gn_solve_fused(pairings, guess, params)

            def plain():
                return solver.solve_in_f64(
                    lambda p, g, pr: gauss_newton.optimal_tf_gauss_newton(p, g, params, pr),
                    pairings, guess)
        else:
            P = stack_pytrees([p for p, _ in problems])
            G = stack_pytrees([g for _, g in problems])

            def fused():
                return torch.func.vmap(
                    lambda p, g: gauss_newton.gn_solve_fused(p, g, params))(P, G)

            def plain():
                return torch.func.vmap(lambda p, g: solver.solve_in_f64(
                    lambda p2, g2, pr: gauss_newton.optimal_tf_gauss_newton(p2, g2, params, pr),
                    p, g))(P, G)
        got, want = fused(), plain()
        torch.cuda.synchronize()
        ulps = max(int(ulps_apart(got.R.cpu(), want.R.cpu()).max()),
                   int(ulps_apart(got.t.cpu(), want.t.cpu()).max()))
        errs.append(max(float((got.R - want.R).abs().max()), float((got.t - want.t).abs().max())))
        check(ulps <= 1, f"gn {label}: kernel within 1 float32 ulp of the plain path ({ulps})")
        g_times = graph_ms(fused)
        ms, call_ms = statistics.median(g_times), cuda_ms(fused)
        plain_ms = cuda_ms(plain, reps=5, warmup=1)
        card_us, by, sm_us = gn_bounds_us(B, n_pt, n_pl, params.max_iterations)
        row = {"shape": f"{B}x{n_pt}+{n_pl}", "what": label, "ms": ms, "call_ms": call_ms,
               "bound_ms": card_us * 1e-3, "bound_by": by, "share_of_bound": card_us * 1e-3 / ms,
               "sm_bound_ms": sm_us * 1e-3, "plain_ms": plain_ms, "library_ms": None,
               "ulps": ulps}
        rows.append(row)
        print(f"[gn] {label}, {params.max_iterations} inner iterations: {ms * 1e3:.2f} us per "
              f"call in a CUDA graph of {GRAPH_LAUNCHES} calls, {call_ms * 1e3:.2f} us for one "
              f"call between events; bound {card_us:.3f} us on the card ({by}, "
              f"{card_us * 1e-3 / ms:.3%}), {sm_us:.2f} us on one SM a problem "
              f"({sm_us * 1e-3 / ms:.1%}); plain path {plain_ms:.3f} ms; "
              f"{ulps} ulp from it on {smi}")
    return rows, errs


# the termination kernel (csrc/icp_terminate.cu) at the cells' shapes: (label,
# problems, the live block, its rows)
TERM_SHAPES = (("stream: 1 x 6144 pt2pl", 1, "pt2pl", 6144),
               ("scan: 1 x 8192 pt2pt", 1, "pt2pt", 8192),
               ("fleet: 8 x 6144 pt2pl", 8, "pt2pl", 6144))
TERM_POSE_BYTES = 48  # a float32 pose: R (36) and t (12)
TERM_OUT_BYTES = TERM_POSE_BYTES + 3 + 16  # the kept pose, the flags, the four norms


def term_bound_us(B, rows):
    """The termination test's bound in us: each byte it needs read once
    (the live block's weights, three poses) and written once (the kept
    pose, the flags, the norms) at the card's bandwidth. Its few hundred
    float32 operations a problem weigh nothing beside that."""
    return B * (4 * rows + 3 * TERM_POSE_BYTES + TERM_OUT_BYTES) / (HBM_TBS * 1e6)


def terminate_problems(seed, B, block, rows):
    """B termination tests on the card, stacked: the live block's weights
    (60% valid), a random pose, the one before it 0.05 rad and 0.3 m away
    and the solver's ~5e-4 m and ~1e-4 rad from it, so about half stall."""
    rng = np.random.RandomState(seed)
    pairings = Pairings.empty(**{f"{block}_cap": rows})
    pairings = dataclasses.replace(pairings, live=frozenset({block}))
    weights = np.where(rng.rand(B, rows) < 0.6, rng.uniform(0.1, 2.0, (B, rows)), 0.0)
    stacked = stack_pytrees([pairings] * B)
    stacked = dataclasses.replace(stacked, **{block: dataclasses.replace(
        getattr(stacked, block), weight=torch.as_tensor(weights, dtype=torch.float32,
                                                        device=default_device()))})
    poses = []
    for b in range(B):
        pose = se3.from_xyz_ypr(*rng.uniform(-50, 50, 3), *rng.uniform(-3, 3, 3))
        prev = se3.compose(pose, se3.from_xyz_ypr(*rng.normal(0, 0.3, 3),
                                                  *rng.normal(0, 0.05, 3)))
        new = se3.compose(pose, se3.from_xyz_ypr(*rng.normal(0, 3e-4, 3),
                                                 *rng.normal(0, 6e-5, 3)))
        poses.append((pose, prev, new))
    return stacked, [stack_pytrees([p[i] for p in poses]) for i in range(3)]


def terminate_phase(smi):
    """The termination kernel at the cells' shapes: its build, each
    problem's flags, kept pose and step norms against the plain path's (bit
    for bit), then its device time per call in a CUDA graph of 20 calls,
    one call between CUDA events, its bound and the plain path's time (one
    call between events: ~264 small kernels, issued from Python). Returns
    (rows, the largest |output - plain output| of each shape)."""
    rec = cuda_build.build_record("icp_terminate")
    for line in rec["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[term] build: {line.strip().removeprefix('ptxas info    : ')}")
    eps = (5e-4, 1e-4)
    rows, errs, seed = [], [], 190
    for label, B, block, n_rows in TERM_SHAPES:
        P, poses = terminate_problems(seed, B, block, n_rows)
        seed += 1

        if B == 1:  # one problem as the ICP loop hands it, unbatched
            one = [torch.utils._pytree.tree_map(lambda x: x[0], v) for v in (P, *poses)]

            def fused():
                return icp_terminate.terminate_fused(*one, *eps)
        else:
            def fused():
                return torch.func.vmap(lambda p, a, pr, n: icp_terminate.terminate_fused(
                    p, a, pr, n, *eps))(P, *poses)

        def plain():
            kept, flags = torch.func.vmap(lambda p, a, pr, n: icp_terminate.terminate_plain(
                p, a, pr, n, *eps))(P, *poses)
            a, prev, new = poses
            return kept, flags, torch.stack([*se3.delta_norms(a, new),
                                             *se3.delta_norms(prev, new)], dim=-1)

        got, want = fused(), plain()
        torch.cuda.synchronize()
        same = all(torch.equal(g.reshape(w.shape), w) for g, w in zip(
            (got[0].R, got[0].t, got[1], got[2]), (want[0].R, want[0].t, want[1], want[2])))
        err = max(float((got[0].R.reshape(want[0].R.shape) - want[0].R).abs().max()),
                  float((got[0].t.reshape(want[0].t.shape) - want[0].t).abs().max()),
                  float((got[2].reshape(want[2].shape) - want[2]).abs().max()))
        errs.append(err)
        check(same, f"term {label}: kernel equals the plain path bit for bit (max |d| {err})")
        g_times = graph_ms(fused)
        ms, call_ms = statistics.median(g_times), cuda_ms(fused)
        plain_ms = cuda_ms(plain, reps=5, warmup=1)
        bound_us = term_bound_us(B, n_rows)
        rows.append({"shape": f"{B}x{n_rows} {block}", "what": label, "ms": ms,
                     "call_ms": call_ms, "bound_ms": bound_us * 1e-3, "bound_by": "bytes",
                     "share_of_bound": bound_us * 1e-3 / ms, "plain_ms": plain_ms,
                     "library_ms": None, "stalled": int(want[1][..., 2].sum()),
                     "no_pairs": int(want[1][..., 0].sum())})
        print(f"[term] {label}: {ms * 1e3:.2f} us per call in a CUDA graph of "
              f"{GRAPH_LAUNCHES} calls, {call_ms * 1e3:.2f} us for one call between events; "
              f"bound {bound_us:.4f} us (bytes, {bound_us * 1e-3 / ms:.3%}); plain path "
              f"{plain_ms:.3f} ms; {rows[-1]['stalled']} of {B} stalled; bit-equal to it "
              f"on {smi}")
    return rows, errs


def work_bound_ms(pairs, queries, points, k):
    """(ms, "operations" or "bytes"): the least time the card can take to
    compare ``pairs`` query-point pairs, reading ``queries`` + ``points``
    rows once and writing k results per query."""
    ops = pairs * 9 / FP32_INSTRUCTIONS_PER_S * 1e3
    moved = (12 * (queries + points) + 8 * queries * k) / BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= moved else (moved, "bytes")


def bound_ms(B, Q, C, k):
    """work_bound_ms of B problems of Q queries against C points, every
    row counted (the work of a sweep without counts)."""
    return work_bound_ms(B * Q * C, B * Q, B * C, k)


def swept_rows(B, Q, C, counts=None):
    """([queries], [points]) a sweep covers in each of its B problems: the
    leading rows of ``counts`` = (query counts, point counts), each None,
    one value or [B], clamped to the capacity as the kernels clamp them."""
    def rows(c, cap):
        if c is None:
            return [cap] * B
        v = [min(max(int(x), 0), cap) for x in c.reshape(-1).tolist()]
        return v * B if len(v) == 1 else v
    return rows(None if counts is None else counts[0], Q), rows(
        None if counts is None else counts[1], C)


def row_counts(x):
    """The count a front end passes for a sentinel-padded array x [(B,) N,
    3]: ``nn_bruteforce.valid_count`` of its valid rows (|x| < 1e7)."""
    return nnb.valid_count((x.abs() < 1e7).all(-1))


def launch_line(B, Q, C, k, counts=None):
    """Print the launch of a sweep of B problems of Q queries against C
    points as the built library forms it for the wrapper's split, beside
    the rows it covers: with counts, only the blocks of query rows below
    the query count sweep, over slices that split the point count on the
    device."""
    n_sm = nnb._sm_count(0)
    split = nnb.sweep_split(Q, C, n_sm, k, B)
    r = nnb.register_tile(Q, C, n_sm, k, B)
    gx, gy, gz, threads = nnb.kernel_launch_dims(Q, B, r, split.groups, split.slices)
    blocks, warps = gx * gy * gz, gx * gy * gz * threads // 32
    nq, npt = swept_rows(B, Q, C, counts)
    per_block = 32 * r
    active = sum(-(-n // per_block) for n in nq) * gy
    slices = sorted({((-(-n // gy)) + 3) & ~3 for n in npt}) if counts else [split.slice_len]
    print(f"[launch] {B}x{Q}x{C} k={k} on {n_sm} SMs, {r} queries per thread: grid ({gx}, "
          f"{gy}, {gz}) x {threads} threads = {blocks} blocks of {threads // 32} warps, {warps} warps = "
          f"{warps / n_sm:.1f} per SM; valid rows swept: queries "
          f"{sum(nq)} of {B * Q}, points {sum(npt)} of {B * C}"
          f"{'' if counts else ' (no counts: every row)'}; {active} of {blocks} blocks sweep, "
          f"{gy} slices of {'/'.join(map(str, slices[:4]))} points")
    return blocks, warps


def data_bound_ms(q, p, k):
    """work_bound_ms of the work this run's data needs: the valid rows of
    q [(B,) Q, 3] against those of p [(B,) C, 3] (a shared map [C, 3] read
    once); the sentinel rows (|x| = 1e8) are padding that no query needs."""
    nq = (q.abs() < 1e7).all(-1).sum(-1)
    npt = (p.abs() < 1e7).all(-1).sum(-1)
    return work_bound_ms(int((nq * npt).sum()), int(nq.sum()), int(npt.sum()), k)


def grid_points(rng, *shape):
    """Points on a coarse integer grid: many exact duplicates and equal
    distances, so the order of the merge decides which index comes back."""
    return torch.from_numpy(rng.randint(0, 6, shape + (3,)).astype(np.float32))


COMPARED = {"without counts": 0, "with counts": 0}


def compare(label, kernel, plain, *args):
    """A kernel against its plain version on the same card tensors: the
    distances must be equal bit for bit (both round (q-p)^2 per product and
    per sum in the same order) and so must the indices (both take the
    lowest index on ties). args: (q, p, k) or (q, p, k, q_count, p_count).
    Returns max |d2 - d2_plain| (0)."""
    COMPARED["with counts" if len(args) > 3 else "without counts"] += 1
    d, i = kernel(*args)
    d_ref, i_ref = plain(*args)
    torch.cuda.synchronize()
    filled = torch.isfinite(d_ref)
    check(torch.equal(torch.isfinite(d), filled), f"{label}: filled slots differ")
    err = float((d[filled] - d_ref[filled]).abs().max()) if bool(filled.any()) else 0.0
    check(err == 0.0, f"{label}: max |d2 - d2_plain| = {err} m^2, not 0")
    n_bad = int((i != i_ref).sum())
    check(n_bad == 0, f"{label}: {n_bad} indices differ from the plain version's")
    print(f"[kernel] {label}: ok, max |d2 - d2_plain| = {err:.3g} m^2 (must be 0), "
          f"indices equal on all {i.numel()} entries")
    return err


MASK_KINDS = ("prefix", "scattered", "count 0", "count 1", "fewer points than k",
              "one valid query", "4n+1", "4n+2", "4n+3")


def kind_masks(kind, Q, C, rng):
    """(query mask, point mask) numpy of one kind of padded cloud: valid
    rows first (a compacted layer), interior invalid rows and a padded
    tail, no valid point, one, fewer than k, one valid query, counts not a
    multiple of 4."""
    qv, pv = np.zeros(Q, bool), np.zeros(C, bool)
    if kind == "prefix":
        qv[:Q * 3 // 4], pv[:C // 2 + 3] = True, True
    elif kind == "scattered":
        qv[:Q - 17], pv[:C - 29] = rng.rand(Q - 17) > 0.3, rng.rand(C - 29) > 0.3
    elif kind == "count 0":
        qv[:] = True
    elif kind == "count 1":
        qv[:Q // 2], pv[0] = True, True
    elif kind == "fewer points than k":
        qv[:], pv[[2, 5, 6]] = True, True
    elif kind == "one valid query":
        qv[Q // 3], pv[:C - 1] = True, True
    else:
        n = int(kind.split("+")[1])
        qv[:4 * 9 + n], pv[:4 * 37 + n] = True, True
    return qv, pv


def same_result(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def counted_cases(errs, dev, q_src, p_src, rng):
    """Phase 3's cases of the counted sweeps, on the card: (a) each kind of
    mask of ``kind_masks`` on street points through K1, the counts those
    of the front end (``nn_bruteforce.valid_count``), against the counted
    plain version bit for bit, and the front end's NNResult against the
    uncounted sweep's (the same, to the bit); (b) integer-grid points
    (ties everywhere) at k = 2, 4, 5, 8 with counts, through K1 and K2
    with per-problem counts, a map per problem and one shared map; (c)
    per-problem counts through the batched front end and through
    torch.func.vmap of knn_bruteforce, against the uncounted sweep; (d) a
    counted front-end call of K1 and of K2 captured in a CUDA graph (a host
    read would refuse the capture) and replayed after its masks changed in
    place: the replay must give the eager call's result on the new masks."""
    q, p = q_src[:777].contiguous(), p_src[:3001].contiguous()
    fronts = 0
    for kind in MASK_KINDS:
        qv, pv = (torch.from_numpy(m).to(dev) for m in kind_masks(kind, 777, 3001, rng))
        qs = torch.where(qv[:, None], q, 1.0e8).contiguous()
        ps = torch.where(pv[:, None], p, -1.0e8).contiguous()
        n = (nnb.valid_count(qv), nnb.valid_count(pv))
        for k in (1, 5, 8):
            errs["knn_bruteforce"].append(compare(
                f"K1 777x3001 k={k} counted, {kind} ({int(n[0])} x {int(n[1])} rows)",
                nnb.knn_sweep, nnb.knn_plain, qs, ps, k, *n))
            got = nnb.knn_bruteforce(q, qv, p, pv, k=k)
            want = nnb._result(*nnb.knn_sweep(qs, ps, k), 3001, None)
            check(same_result(got, want), f"front end k={k}, {kind}: the counted NNResult "
                  f"differs from the uncounted sweep's")
            fronts += 1
    for k in (2, 4, 5, 8):
        for Q, C in ((777, 3001), (5000, 20011)):
            qg, pg = grid_points(rng, Q).to(dev), grid_points(rng, C).to(dev)
            n = (torch.tensor(Q * 2 // 3 + 1, dtype=torch.int32, device=dev),
                 torch.tensor(C * 3 // 5 + 2, dtype=torch.int32, device=dev))
            errs["knn_bruteforce"].append(compare(
                f"K1 {Q}x{C} k={k} integer grid (ties), counted {int(n[0])} x {int(n[1])}",
                nnb.knn_sweep, nnb.knn_plain, qg, pg, k, *n))
        for shared in (False, True):
            B, Q, C = BATCH, 777, 3001
            qg = grid_points(rng, B, Q).to(dev)
            pg = grid_points(rng, *(() if shared else (B,)), C).to(dev)
            n = (torch.from_numpy(rng.randint(0, Q + 1, B).astype(np.int32)).to(dev),
                 torch.from_numpy(rng.randint(0, C + 1, 1 if shared else B).astype(np.int32)
                                  ).to(dev))
            n[0][0], n[1][-1] = 0, C  # a problem without a query, a map swept whole
            errs["knn_batched"].append(compare(
                f"K2 {B}x{Q}x{C} k={k} integer grid (ties), per-problem counts "
                f"{n[0].tolist()} x {n[1].tolist()}{', shared map' if shared else ''}",
                nnb.knn_sweep_batched, nnb.knn_plain_batched, qg, pg, k, *n))
    for shared in (False, True):
        B = BATCH
        qb = q.expand(B, -1, -1).contiguous()
        pb = p if shared else torch.stack([p.roll(37 * b, 0) for b in range(B)])
        qv = torch.stack([torch.arange(777, device=dev) < 97 * b for b in range(B)])
        pv = (torch.arange(3001, device=dev) < 2000) if shared else torch.stack(
            [torch.arange(3001, device=dev) < 400 * b + 3 for b in range(B)])
        for k in (1, 8):
            got = nnb.knn_bruteforce_batched(qb, qv, pb, pv, k=k)
            mapped = torch.func.vmap(
                (lambda qq, vv: nnb.knn_bruteforce(qq, vv, pb, pv, k=k)) if shared else
                (lambda qq, vv, pp, ww: nnb.knn_bruteforce(qq, vv, pp, ww, k=k)))(
                *((qb, qv) if shared else (qb, qv, pb, pv)))
            qs = torch.where(qv[..., None], qb, 1.0e8).contiguous()
            ps = torch.where(pv[..., None], pb, -1.0e8).contiguous()
            want = nnb._result(*nnb.knn_sweep_batched(qs, ps, k), 3001, None)
            check(same_result(got, want) and same_result(mapped, want),
                  f"batched front end k={k}{' shared map' if shared else ''}: the counted "
                  f"NNResult differs from the uncounted sweep's")
            fronts += 2
    # (d) a counted call in a CUDA graph, replayed on changed masks
    for batched in (False, True):
        qq = q.expand(BATCH, -1, -1).contiguous() if batched else q
        qv = torch.ones(qq.shape[:-1], dtype=torch.bool, device=dev)
        pv = torch.ones(3001, dtype=torch.bool, device=dev)
        front = nnb.knn_bruteforce_batched if batched else nnb.knn_bruteforce

        def call():
            return front(qq, qv, p, pv, k=8)

        call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for n_q, n_p in ((500, 1234), (0, 3001), (777, 5)):
            qv.copy_(torch.arange(777, device=dev).expand_as(qv) < n_q)
            pv.copy_(torch.arange(3001, device=dev) < n_p)
            graph.replay()
            check(same_result(out, call()), f"{'K2' if batched else 'K1'} counted front end: "
                  f"the graph's replay on {n_q} x {n_p} valid rows differs from the eager call")
        del graph
    print(f"[kernel] counted front ends: {fronts} NNResults equal to the uncounted sweep's to "
          f"the bit; a counted K1 and K2 front-end call captured in a CUDA graph (no host "
          f"read) and replayed on 3 other pairs of masks, equal to the eager calls")


def timed_aligns(icp, loc, glob, params, n, guess=None):
    """n synchronised aligns; returns (host-clock seconds of each, last result)."""
    guess = guess or se3.identity()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = icp.align(loc, glob, guess, params)
        float(res.optimal_tf.t[0])  # syncs
        walls.append(time.perf_counter() - t0)
    return walls, res


def profile_window(label, run, n, smi, tables, warmups=2):
    """torch.profiler over n warm calls of run() (each ends in a host sync):
    wall time, device kernel time and busy share, launch/copy/sync counts
    and the kNN kernels' rows; appends the profiler's tables to tables.
    Returns {"wall_ms", "device_ms", "kernels", "host": {runtime call:
    count}, "ops": {aten op: count}, "knn": {kernel: (launches, ms)}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmups):
        run()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ka = prof.key_averages()
    # kernel rows only: an op row's self device time repeats its kernels'
    dev_ms = sum(e.self_device_time_total for e in ka
                 if e.device_type == DeviceType.CUDA) / 1e3
    n_kernels = sum(e.count for e in ka if e.device_type == DeviceType.CUDA)
    print(f"[profile] {label}: {n} calls under torch.profiler: wall {wall_ms:.1f} ms, "
          f"device kernel time {dev_ms:.3f} ms ({n_kernels} kernels), busy "
          f"{dev_ms / wall_ms:.4f}, idle {1 - dev_ms / wall_ms:.4f} on {smi}")
    out = {"wall_ms": wall_ms, "device_ms": dev_ms, "kernels": n_kernels, "host": {}, "knn": {},
           "ops": {e.key: e.count for e in ka if e.key.startswith("aten::")}}
    for e in ka:
        if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemcpyAsync",
                     "cudaStreamSynchronize", "cudaDeviceSynchronize"):
            out["host"][e.key] = e.count
            print(f"[profile]   {e.key}: {e.count} calls, "
                  f"host {e.self_cpu_time_total / 1e3:.2f} ms")
        name = re.search(r"knn_\w+(<\d+>)?", e.key)  # the template argument is k
        if e.device_type == DeviceType.CUDA and name:
            out["knn"][name.group(0)] = (e.count, e.self_device_time_total / 1e3)
            print(f"[profile]   {name.group(0)}: {e.count} launches, "
                  f"{e.self_device_time_total / 1e3:.3f} ms")
    tables.append(f"== {label}\n" + ka.table(sort_by="self_cpu_time_total", row_limit=40)
                  + "\n\n" + ka.table(sort_by="self_device_time_total", row_limit=20))
    return out


def synced_sections(wrapped, run):
    """Host seconds spent in each (owner, attribute, label) of ``wrapped``
    during run(), with a device sync before and after each call (which adds
    its own cost). Returns ({label: seconds}, what run() returned)."""
    sections = {}

    def synced(f, label):
        def g(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = f(*a, **kw)
            torch.cuda.synchronize()
            sections[label] = sections.get(label, 0.0) + time.perf_counter() - t0
            return r
        return g

    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in wrapped]
    try:
        for (owner, name, label), (_, _, f) in zip(wrapped, saved):
            setattr(owner, name, synced(f, label))
        result = run()
    finally:
        for owner, name, f in saved:
            setattr(owner, name, f)
    return sections, result


def profile_align(icp, loc, glob, params, smi, tables):
    """Where a warm scan-to-scan align's time goes: torch.profiler over 2
    aligns, then the sections' host times with a sync around each (which
    adds its own cost)."""
    from mp2p_icp_tpu_torch import icp as icp_mod
    from mp2p_icp_tpu_torch.matchers import adaptive, distance_threshold
    from mp2p_icp_tpu_torch.solvers import gauss_newton, horn, solver

    walls, res = timed_aligns(icp, loc, glob, params, 2)
    print(f"[profile] warm aligns {[round(w * 1e3, 1) for w in walls]} ms, "
          f"{res.n_iterations} iterations, on {smi}")
    profile_window("scan to scan, KITTI config",
                   lambda: timed_aligns(icp, loc, glob, params, 1), 2, smi, tables)

    wrapped = [
        (distance_threshold, "knn_bruteforce", "knn (DistanceThreshold)"),
        (adaptive, "knn_bruteforce", "knn (Adaptive)"),
        (distance_threshold, "resolve_one_to_one", "one-to-one"),
        (adaptive, "adaptive_threshold_sq", "adaptive threshold"),
        (icp_mod.ICP, "_run_matchers", "matchers total"),
        (solver.SolverHorn, "solve", "Horn solve"),
        (solver.SolverGaussNewton, "solve", "GN solve"),
        (gauss_newton, "gn_build_normal_equations", "GN normal equations"),
        (gauss_newton, "solve_normal_equations", "GN Cholesky solve"),
        (horn, "max_eigvec_4x4", "Horn power iteration"),
        (se3, "delta_norms", "termination delta_norms"),
        (icp_mod, "compute_covariance", "covariance"),
        (icp_mod.ICP, "_quality_stack", "quality"),
    ]
    sections, (walls, _) = synced_sections(
        wrapped, lambda: timed_aligns(icp, loc, glob, params, 3))
    print(f"[profile] sectioned aligns {[round(w * 1e3, 1) for w in walls]} ms "
          f"(a sync around each section)")
    for label, secs in sorted(sections.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {label:26s} {secs / 3 * 1e3:8.2f} ms per align")


def profile_odometry(mapper, frames, twists, pose0, smi, tables):
    """Where the odometry run's time goes: torch.profiler over one warm run
    (the seed and every frame; per-frame figures divide by the frames after
    the first, so the seed's filters, insert and fit are in them), then each
    stage's host time with a sync around it."""
    from mp2p_icp_tpu_torch import odometry as odometry_mod

    def run():
        return mapper.run(frames, twists=twists, dt=ODO_DT, initial_pose=pose0)

    steps = len(frames) - 1
    prof = profile_window(f"odometry, {len(frames)} frames", run, 1, smi, tables, warmups=0)
    syncs = prof["host"].get("cudaStreamSynchronize", 0) + prof["host"].get(
        "cudaDeviceSynchronize", 0)
    print(f"[profile] odometry per frame ({steps} steps; the seed's share included): "
          f"{prof['wall_ms'] / steps:.1f} ms wall under the profiler, "
          f"{prof['device_ms'] / steps:.3f} ms of kernels, {prof['kernels'] / steps:.0f} kernel "
          f"launches, {syncs / steps:.1f} host syncs")
    # the claim of a probe round is the path's only scatter-reduce
    print(f"[profile]   map insert: {prof['ops'].get('aten::scatter_reduce_', 0) / len(frames):.2f} "
          f"probe rounds per insert ({len(frames)} inserts, the seed's included), "
          f"{prof['host'].get('cudaMemcpyAsync', 0) / steps:.0f} copies per frame")
    for name, (count, ms) in sorted(prof["knn"].items()):
        print(f"[profile]   {name}: {count / steps:.2f} launches per frame, "
              f"{ms / count * 1e3:.1f} us each, {ms / steps:.4f} ms per frame")

    wrapped = [
        (FilterDeskew, "__call__", "deskew"),
        (FilterDecimateVoxels, "__call__", "decimate (FirstPoint, sort)"),
        (ICP, "_crop_globals", "crop"),
        (ICP, "_align_core", "align"),
        (odometry_mod, "hash_map_insert", "map insert"),
        (odometry_mod, "estimate_point_normals", "normals fit"),
    ]
    sections, r = synced_sections(wrapped, run)
    total_ms = r["frame_seconds"].sum() * 1e3
    print(f"[profile] odometry stages with a sync around each: {total_ms / steps:.1f} ms per "
          f"frame, {r['iterations'].mean():.2f} ICP iterations per frame")
    for label, secs in sorted(sections.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {label:28s} {secs / steps * 1e3:8.2f} ms per frame")


def fleet_phase(mapper, frames, twists, gt, run_36, launches, by_path, smi, kind):
    """Phase 8. ``run_36``: the result of OdometryMapper.run on the whole
    drive (phase 7), which OdometryMapper.run_offline must equal. Adds the
    phase's launches to ``launches`` / ``by_path``; returns what
    profile_fleet needs."""
    n = FLEET_FRAMES
    offs = [FLEET_STRIDE * b for b in range(BATCH)]
    streams = [frames[o:o + n] for o in offs]
    stream_tw = [twists[o:o + n] for o in offs]
    p0s = [pose_of(gt[o]) for o in offs]
    bm = BatchedOdometryMapper(mapper)
    kw = dict(twists=stream_tw, initial_poses=p0s, dt=ODO_DT)

    # the deliberate host reads (bool() of a device flag: one per ICP
    # iteration, one per probe round after the unconditional ones) and the
    # probe rounds (each round's claim is the path's only scatter-reduce)
    # of the fleet's first run, counted by wrapping the two methods; the
    # seeds' share is read off when the staging ends
    tally = {"reads": 0, "rounds": 0}
    seeds = {}
    real_stage = bm._stage

    def counting_stage(*a, **k):
        out = real_stage(*a, **k)
        seeds.update(tally)
        return out

    real_bool, real_reduce = torch.Tensor.__bool__, torch.Tensor.scatter_reduce_

    def counting_bool(self):
        tally["reads"] += self.is_cuda
        return real_bool(self)

    def counting_reduce(self, *a, **k):
        tally["rounds"] += 1
        return real_reduce(self, *a, **k)

    fleet_runs = []
    for label, fn in (("run", bm.run), ("run_offline, cold", bm.run_offline),
                      ("run_offline, warm", bm.run_offline)):
        torch.cuda.synchronize()
        reset_counts()
        if label == "run":
            torch.Tensor.__bool__, torch.Tensor.scatter_reduce_ = counting_bool, counting_reduce
            bm._stage = counting_stage
        try:
            r = fn(streams, **kw)
        finally:
            torch.Tensor.__bool__, torch.Tensor.scatter_reduce_ = real_bool, real_reduce
            bm._stage = real_stage
        torch.cuda.synchronize()
        c = counts()
        slowest = r["iterations"].max(axis=0)  # a fleet frame runs its slowest stream's
        calls = sum(matcher_calls(mapper.icp, int(it)) for it in slowest) + (n - 1)
        check(c["knn_batched"] == calls,
              f"fleet {label}: K2 launches {c['knn_batched']} != fleet ICP iterations "
              f"+ normals fits {calls}")
        check(c["knn_bruteforce"] == BATCH and c["knn_streamed"] == 0,
              f"fleet {label}: K1 launches must be the {BATCH} seeds, K3 none: {c}")
        launches["knn_batched"] += c["knn_batched"]
        launches["knn_bruteforce"] += c["knn_bruteforce"]
        by_path["knn_batched"]["fleet"] = c["knn_batched"]
        by_path["knn_bruteforce"]["fleet"] = c["knn_bruteforce"]
        count_own(launches, by_path, c, "fleet")
        frame_ms = r["frame_seconds"] * 1e3
        print(f"[fleet] {label}: {BATCH} streams x {n} frames on {kind}: {r['scans_per_s']:.2f} "
              f"scans/s in all, ms per fleet frame median {np.median(frame_ms):.1f} max "
              f"{frame_ms.max():.1f} (sensor period {SENSOR_PERIOD_MS:.0f} ms per robot); ICP "
              f"iterations per fleet frame mean {slowest.mean():.2f} max {slowest.max()} "
              f"(the streams' own mean {r['iterations'].mean():.2f}); K2 launches "
              f"{c['knn_batched']} = {int(slowest.sum())} iterations + {n - 1} fits "
              f"({c['knn_batched'] / (n - 1):.2f} per fleet frame), K1 {c['knn_bruteforce']} "
              f"(the seeds), K3 0 on {smi}")
        check(r["poses"].shape == (BATCH, n, 4, 4) and np.isfinite(r["poses"]).all(),
              f"fleet {label}: poses not finite")
        check(r["qualities"].shape == (BATCH, n - 1) and np.isfinite(r["qualities"]).all(),
              f"fleet {label}: a quality is not finite")
        fleet_runs.append(r)
    rb = fleet_runs[0]
    reads, rounds = (tally[key] - seeds[key] for key in ("reads", "rounds"))
    print(f"[fleet] run, per fleet frame: {reads / (n - 1):.2f} deliberate host reads "
          f"({int(rb['iterations'].max(axis=0).sum())} for the ICP iterations, the rest the "
          f"probe loop's), {rounds / (n - 1):.2f} probe rounds per fleet insert; the {BATCH} "
          f"seeds' inserts took {seeds['rounds'] / BATCH:.2f} rounds and "
          f"{seeds['reads'] / BATCH:.2f} reads each")

    for r in fleet_runs[1:]:
        same = all(np.array_equal(rb[key], r[key])
                   for key in ("poses", "qualities", "iterations", "map_counts"))
        check(same and states_equal(rb["map_states"], r["map_states"]),
              "fleet: run_offline differs from run")
    print("[fleet] run_offline equals run to the bit (poses, qualities, iterations, map "
          f"states), {len(fleet_runs) - 1} times")

    # one stream: run_offline on the whole drive against phase 7's run
    torch.cuda.synchronize()
    reset_counts()
    r_off = mapper.run_offline(frames, twists=twists, dt=ODO_DT, initial_pose=pose_of(gt[0]))
    torch.cuda.synchronize()
    c = counts()
    launches["knn_bruteforce"] += c["knn_bruteforce"]
    by_path["knn_bruteforce"][f"odometry run_offline, {len(frames)} frames"] = c["knn_bruteforce"]
    count_own(launches, by_path, c, f"odometry run_offline, {len(frames)} frames")
    check(c["knn_bruteforce"] == int(r_off["iterations"].sum()) + len(frames)
          and c["knn_batched"] == c["knn_streamed"] == 0,
          f"odometry run_offline: launches {c}")
    same = all(np.array_equal(run_36[key], r_off[key])
               for key in ("poses", "qualities", "iterations", "map_counts"))
    check(same and states_equal(run_36["map_state"], r_off["map_state"]),
          "odometry: run_offline differs from run")
    off_ms = r_off["frame_seconds"] * 1e3
    run_ms = run_36["frame_seconds"] * 1e3
    print(f"[odometry] run_offline on the {len(frames)} frames equals run to the bit; "
          f"{r_off['scans_per_s']:.2f} scans/s, ms per frame median {np.median(off_ms):.1f} "
          f"(run, warm: {run_36['scans_per_s']:.2f} scans/s, median {np.median(run_ms):.1f}) "
          f"on {smi}")

    # the same streams one after another, in the same call
    seq_s, seq_calls = 0.0, 0
    reset_counts()
    for b in range(BATCH):
        torch.cuda.synchronize()
        rs = mapper.run(streams[b], twists=stream_tw[b], initial_pose=p0s[b], dt=ODO_DT)
        torch.cuda.synchronize()
        seq_s += (n - 1) / rs["scans_per_s"]
        seq_calls += int(rs["iterations"].sum()) + (n - 1) + 1  # matcher calls, fits, the seed
        gap = float(np.abs(rb["poses"][b] - rs["poses"]).max())
        ate = ate_rmse(rb["poses"][b], gt[offs[b]:offs[b] + n])
        n_map, n_seq = int(rb["maps"].count[b]), int(rs["map"].count)
        ref = FLEET_JAX[b]
        print(f"[fleet] stream {b} (frames {offs[b]}..{offs[b] + n - 1}): ATE {ate:.4f} m, map "
              f"{n_map} points, iterations mean {rb['iterations'][b].mean():.2f} [JAX CPU "
              f"reference: {ref['ate_m']} m, {ref['map_points']} points, "
              f"{ref['iterations_mean']}]; sequential run: max |R, t difference| {gap:.3g}, "
              f"map {n_seq} points, {rs['scans_per_s']:.2f} scans/s")
        check(gap <= 1e-5, f"fleet stream {b}: poses differ from the sequential run by {gap}")
        check(np.array_equal(rb["iterations"][b], rs["iterations"]),
              f"fleet stream {b}: iterations {rb['iterations'][b]} != sequential "
              f"{rs['iterations']}")
        check(n_map == n_seq, f"fleet stream {b}: map {n_map} points, sequential {n_seq}")
        check(int(rb["map_states"].n_dropped[b]) == 0 and int(rs["map_state"].n_dropped) == 0,
              f"fleet stream {b}: points dropped")
        check(ate < ATE_LIMIT and ate <= max(1.5 * ref["ate_m"], ref["ate_m"] + 0.01),
              f"fleet stream {b}: ATE {ate} m outside max(1.5 x, + 0.01 m) of the JAX CPU "
              f"reference {ref['ate_m']}")
        check(abs(n_map - ref["map_points"]) <= 0.02 * ref["map_points"],
              f"fleet stream {b}: {n_map} map points, not within 2% of {ref['map_points']}")
    c = counts()
    check(c["knn_bruteforce"] == seq_calls and c["knn_batched"] == 0,
          f"sequential streams: K1 launches {c['knn_bruteforce']} != {seq_calls}, or K2 ran: {c}")
    launches["knn_bruteforce"] += c["knn_bruteforce"]
    by_path["knn_bruteforce"][f"the fleet's {BATCH} streams one after another"] = c["knn_bruteforce"]
    count_own(launches, by_path, c, f"the fleet's {BATCH} streams one after another")
    print(f"[fleet] aggregate: run {rb['scans_per_s']:.2f} scans/s, run_offline cold "
          f"{fleet_runs[1]['scans_per_s']:.2f}, warm {fleet_runs[2]['scans_per_s']:.2f}; the same "
          f"{BATCH} streams one after another {BATCH * (n - 1) / seq_s:.2f} scans/s on {smi}")
    return bm, streams, kw


def profile_fleet(bm, streams, kw, smi, tables):
    """Where a warm fleet run's time goes: torch.profiler over one run, then
    each stage's host time with a sync around it."""
    from mp2p_icp_tpu_torch import odometry as odometry_mod

    def run():
        return bm.run(streams, **kw)

    steps = len(streams[0]) - 1
    prof = profile_window(f"fleet, {len(streams)} streams x {steps + 1} frames", run, 1, smi,
                          tables, warmups=0)
    syncs = prof["host"].get("cudaStreamSynchronize", 0) + prof["host"].get(
        "cudaDeviceSynchronize", 0)
    print(f"[profile] fleet per fleet frame ({steps} steps; the seeds' share included): "
          f"{prof['wall_ms'] / steps:.1f} ms wall under the profiler, "
          f"{prof['device_ms'] / steps:.3f} ms of kernels, {prof['kernels'] / steps:.0f} kernel "
          f"launches, {syncs / steps:.1f} host syncs, "
          f"{prof['host'].get('cudaMemcpyAsync', 0) / steps:.0f} copies")
    for name, (count, ms) in sorted(prof["knn"].items()):
        print(f"[profile]   {name}: {count / steps:.2f} launches per fleet frame, "
              f"{ms / count * 1e3:.1f} us each, {ms / steps:.4f} ms per fleet frame")
    wrapped = [
        (FilterDeskew, "__call__", "deskew"),
        (FilterDecimateVoxels, "__call__", "decimate (FirstPoint, sort)"),
        (odometry_mod, "crop_batched", "crop"),
        (odometry_mod, "_align_batched", "align"),
        (odometry_mod, "hash_map_insert", "map insert"),
        (odometry_mod, "estimate_point_normals", "normals fit"),
    ]
    sections, r = synced_sections(wrapped, run)
    print(f"[profile] fleet stages with a sync around each: "
          f"{r['frame_seconds'].sum() * 1e3 / steps:.1f} ms per fleet frame, "
          f"{r['iterations'].max(axis=0).mean():.2f} ICP iterations per fleet frame")
    for label, secs in sorted(sections.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {label:28s} {secs / steps * 1e3:8.2f} ms per fleet frame")


def held_align(icp, loc, glob, guess, params, label, ref, kind, launches, by_path,
               planar=False, tag="engine"):
    """One align on the card held to a JAX CPU reference ``ref``
    (termination, iterations within iterations_agree, pose gap < 5e-3) and
    K1's launches to the matcher calls; adds them to ``launches``, and the
    Gauss-Newton kernel's to ``launches`` and ``by_path``. Returns (result,
    K1 launches, host seconds)."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = icp.align(loc, glob, guess, params)
    float(res.optimal_tf.t[0])  # syncs
    wall = time.perf_counter() - t0
    n = counts()
    calls = matcher_calls(icp, res.n_iterations)
    check(n["knn_bruteforce"] == calls and calls > 0,
          f"{label}: K1 launches {n['knn_bruteforce']} != matcher calls {calls}")
    check(n["knn_streamed"] == n["knn_batched"] == 0, f"{label}: K2/K3 ran: {n}")
    launches["knn_bruteforce"] += n["knn_bruteforce"]
    count_own(launches, by_path, n, f"{tag} {label}")
    gap = float(se3.error_log_norm(pose_of_log(ref["log"], res.optimal_tf.t.device),
                                   res.optimal_tf))
    print(f"[{tag}] {label} on {kind}: {res.n_iterations} iterations, "
          f"{res.termination_reason.name}, quality {float(res.quality):.6f}, pose gap to "
          f"JAX {gap:.3g} [JAX CPU reference: {ref['iterations']}, {ref['termination']}, "
          f"{ref['quality']:.6f}]; {n['knn_bruteforce']} K1 launches, {wall * 1e3:.1f} ms")
    check(res.termination_reason.name == ref["termination"],
          f"{label}: {res.termination_reason.name}, JAX {ref['termination']}")
    check(iterations_agree(res.n_iterations, ref["iterations"], planar),
          f"{label}: {res.n_iterations} iterations, JAX {ref['iterations']}")
    check(gap < 5e-3, f"{label}: pose {gap} from the JAX reference's")
    return res, n["knn_bruteforce"], wall


def engine_phase(smi, kind, launches, by_path):
    """Phase 9: the rest of the ICP engine on the card. (a) the bench pair
    through engine_icp() three times: with a hook that never stops, with
    none, with one that stops at iteration ENGINE_HOOK_STOP; (b) the 2D demo
    on the planar pairs. Each align is held to the JAX CPU reference and
    K1's launches to the matcher calls; adds K1's launches to ``launches``
    and ``by_path``. Returns ({label: (K1 launches per align, ms per
    align)}, {label: a warm align of the cell, for the profile phase}, the
    2D results pair by pair)."""
    out_dir = pathlib.Path(__file__).resolve().parent / "chiprun_out" / "engine"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("engine-*.icplog.npz"):
        old.unlink()
    per_align = {}

    # (a) 3D: the bench pair with voxel grids, three runs
    loc, glob = street_pair(make_scene(np.random.RandomState(0)), 1, 2)
    loc, glob = with_voxel_grid(loc), with_voxel_grid(glob)
    icp = engine_icp()
    gt = se3.from_xyz_ypr(*GT)
    hooks = {"passive hook": lambda it, R, t, n: torch.zeros((), dtype=torch.bool, device=R.device),
             "no hook": None,
             "stopping hook": lambda it, R, t, n: it >= ENGINE_HOOK_STOP}
    debug_dump.reset_unique_id_counter()
    runs, walls, k1 = {}, [], 0
    for label in ENGINE_RUNS:
        ref = ENGINE_JAX["no hook" if label == "passive hook" else label]
        res, n_k1, wall = held_align(icp, loc, glob, se3.identity(), engine_params(
            out_dir, hooks[label]), f"3D, {label}", ref, kind, launches, by_path)
        err = float(se3.error_log_norm(gt, res.optimal_tf))
        scale = float(res.optimal_scale)
        print(f"[engine] 3D, {label}: SE(3) error {err:.6f}, optimal scale {scale:.7f} "
              f"[JAX CPU reference {ref['scale']:.7f}]")
        check(abs(scale - ref["scale"]) <= 1e-4 * ref["scale"],
              f"3D {label}: scale {scale}, JAX {ref['scale']}")
        if hooks[label] is None or label == "passive hook":
            # the stopped run ends at iteration 5, short of convergence
            check(err < ERR_LIMIT, f"3D {label}: SE(3) error {err} >= {ERR_LIMIT}")
        runs[label] = res
        walls.append(wall)
        k1 += n_k1
    by_path["knn_bruteforce"]["engine 3D, 3 aligns"] = k1
    per_align["engine 3D"] = (k1 / len(ENGINE_RUNS), statistics.median(walls) * 1e3)
    a, b = runs["passive hook"], runs["no hook"]
    check(torch.equal(a.optimal_tf.R, b.optimal_tf.R) and torch.equal(a.optimal_tf.t, b.optimal_tf.t)
          and a.n_iterations == b.n_iterations and torch.equal(a.iteration_poses.t,
                                                               b.iteration_poses.t),
          "the passive hook changed the align")
    stopped = runs["stopping hook"]
    check(stopped.termination_reason == IterTermReason.HOOK_REQUEST
          and stopped.n_iterations == ENGINE_HOOK_STOP + 1,
          f"stopping hook: {stopped.termination_reason.name} after {stopped.n_iterations}")
    poses, n_it = b.iteration_poses, b.n_iterations
    check(poses.t.shape == (40, 3) and b.iteration_pair_counts.shape == (40,)
          and b.iteration_pairings.pt2pl.weight.shape[0] == 40, "records: not 40 rows")
    check(torch.equal(poses.t[-1], b.optimal_tf.t) and torch.equal(poses.R[-1], b.optimal_tf.R),
          "records: the last row is not optimal_tf")
    check(bool((poses.t[n_it - 1:] == poses.t[-1]).all()), "records: the tail does not repeat")
    files = sorted(out_dir.glob("engine-*.icplog.npz"))
    check(len(files) == len(ENGINE_RUNS), f"debug files: {[f.name for f in files]}")
    log = icplog.load_log(files[1])
    kept = -(-40 // ICPParameters().decimation_iteration_details)  # 1 recorded row of 10
    check(log["meta"]["n_iterations"] == n_it and log["iterations"]["poses"].t.shape == (kept, 3)
          and torch.equal(log["result"].t, b.optimal_tf.t), f"debug file {files[1].name}")
    print(f"[engine] 3D: the passive hook equals no hook to the bit; the stopping hook ended "
          f"with HOOK_REQUEST after {stopped.n_iterations} iterations; 40 recorded rows, the "
          f"last = optimal_tf, rows {n_it - 1}-39 repeat it; {len(files)} debug files, "
          f"{files[1].name} loads with its {kept} rows of 40 ({files[1].stat().st_size} bytes)")

    # (b) 2D: the demo on the planar pairs
    icp2, params2 = point2line_icp(), point2line_params()
    walls, k1, planar = [], 0, []
    for i, ((g, l, rel), ref) in enumerate(zip(planar_pairs(), PLANAR_JAX)):
        res, n_k1, wall = held_align(icp2, planar_layers(l), planar_layers(g),
                                     se3.from_xyz_ypr(*planar_guess(rel)), params2,
                                     f"2D pair {i} ({len(l)} x {len(g)} returns)", ref, kind,
                                     launches, by_path, planar=True)
        err = float(se3.error_log_norm(se3.from_xyz_ypr(rel[0], rel[1], 0.0, rel[2], 0.0, 0.0),
                                       res.optimal_tf))
        print(f"[engine] 2D pair {i}: SE(3) error {err:.6f}")
        planar.append(res)
        check(err < ERR_LIMIT, f"2D pair {i}: SE(3) error {err} >= {ERR_LIMIT}")
        walls.append(wall)
        k1 += n_k1
    by_path["knn_bruteforce"][f"engine 2D, {PLANAR_PAIRS} aligns"] = k1
    per_align["engine 2D"] = (k1 / PLANAR_PAIRS, statistics.median(walls) * 1e3)
    for label, (n_k1, ms) in per_align.items():
        print(f"[engine] {label}: {n_k1:.1f} K1 launches per align, median "
              f"{ms:.1f} ms per align on the host clock, on {smi}")
    g0, l0, rel0 = planar_pairs(n_pairs=1)[0]
    warm = {
        "engine 3D, no hook": lambda: float(icp.align(
            loc, glob, se3.identity(), engine_params(out_dir)).optimal_tf.t[0]),
        "engine 2D, pair 0": lambda: float(icp2.align(
            planar_layers(l0), planar_layers(g0), se3.from_xyz_ypr(*planar_guess(rel0)),
            params2).optimal_tf.t[0]),
    }
    return per_align, warm, planar


def profile_engine(run, smi):
    """Where a warm 3D engine align's host time goes: its sections with a
    sync around each (which adds its own cost), over 3 aligns."""
    from mp2p_icp_tpu_torch import icp as icp_mod
    from mp2p_icp_tpu_torch.core import pairings
    from mp2p_icp_tpu_torch.matchers import adaptive, inlier_ratio
    from mp2p_icp_tpu_torch.solvers import solver

    wrapped = [
        (icp_mod.ICP, "_run_matchers", "matchers total"),
        (inlier_ratio, "knn_bruteforce", "knn (InlierRatio, k=1)"),
        (adaptive, "knn_bruteforce", "knn (Adaptive, k=8)"),
        (adaptive, "estimate_points_eigen", "plane fits"),
        (solver.SolverOLAE, "solve", "OLAE solve"),
        (solver.SolverGaussNewton, "solve", "GN solve"),
        (se3, "delta_norms", "termination delta_norms"),
        (pairings.Pairings, "decimated", "records (decimated pairings)"),
        (icp_mod.ICP, "_quality_stack", "quality (3 evaluators)"),
        (icp_mod.ICP, "_optimal_scale", "scale"),
        (icp_mod, "compute_covariance", "covariance"),
        (icp_mod, "save_icp_debug_file", "debug file"),
    ]
    t0 = time.perf_counter()
    sections, _ = synced_sections(wrapped, lambda: [run() for _ in range(3)])
    wall = (time.perf_counter() - t0) / 3
    print(f"[profile] engine 3D, sectioned aligns: {wall * 1e3:.1f} ms per align "
          f"(a sync around each section) on {smi}")
    for label, secs in sorted(sections.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {label:30s} {secs / 3 * 1e3:8.2f} ms per align")


def sm2mm_build(inputs, precise):
    """The port's SimpleMap of ``sm2mm_inputs`` on the default device and
    its YAML config."""
    from mp2p_icp_tpu_torch.filters.generator import Observation
    from mp2p_icp_tpu_torch.filters.sm2mm import Keyframe, SimpleMap

    sm = SimpleMap([Keyframe(pose=pose_of(T), twist=tw,
                             observations=[Observation(**o) for o in obs])
                    for T, tw, obs in inputs])
    return sm, sm2mm_config(precise)


def layers_numpy(layers):
    """{name: dict of numpy arrays} of either package's layers (a point
    layer's fields, a voxel layer's keys / occupancy / valid, a 2-D grid's
    occupancy)."""
    def arr(x):
        return None if x is None else (x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x))

    out = {}
    for name, layer in layers.items():
        if hasattr(layer, "keys") and hasattr(layer, "valid"):  # a voxel layer
            out[name] = {"keys": arr(layer.keys), "occupancy": arr(layer.occupancy),
                         "valid": arr(layer.valid)}
        elif hasattr(layer, "origin_xy"):  # a 2-D grid
            out[name] = {"occupancy": arr(layer.occupancy)}
        else:
            out[name] = {f: arr(getattr(layer, f)) for f in
                         ("xyz", "count", "intensity", "ring", "time", "normals")}
    return out


def sm2mm_numpy(layers):
    """The arrays of either package's built map that ``sm2mm_summary`` reads."""
    ly = layers_numpy(layers)

    def rows(name):
        return ly[name]["xyz"][: int(ly[name]["count"])]

    return {"map_points": rows("map_points"), "deskewed": rows("deskewed"),
            "static_points": int(ly["static_points"]["count"]),
            "dynamic_points": int(ly["dynamic_points"]["count"]), **ly["voxelmap"]}


def sm2mm_phase(smi, kind, launches, by_path, gt, twists, scans, tables):
    """Phase 10: the demo sm2mm YAML on the first SM2MM_KEYFRAMES frames of
    the street drive, pass 1 (constant twist from vx..wz) and pass 2 (the
    precise deskew from IMU samples and a comment's velocity buffer), each
    held to SM2MM_JAX. Returns pass 1's {"simple_map", "summary" (of its
    map), "raw_rows"} for the apps phase."""
    from mp2p_icp_tpu_torch.filters import apply_filter_pipeline
    from mp2p_icp_tpu_torch.filters.sm2mm import simplemap_to_metricmap
    from mp2p_icp_tpu_torch.ops.voxel_occupancy import lookup_occupancy
    from mp2p_icp_tpu_torch.pipeline import filter_pipeline_from_yaml

    last = {}
    for label, precise in (("pass 1", False), ("pass 2", True)):
        ref = SM2MM_JAX[label]
        inputs = sm2mm_inputs(gt, twists, scans, precise=precise)
        sm, cfg = sm2mm_build(inputs, precise)
        n_raw = sum(len(o["xyz"]) for _, _, obs in inputs for o in obs if "xyz" in o)
        capacity = next(f["params"]["target_capacity"] for f in cfg["filters"]
                        if f["class_name"].endswith("FilterMerge"))
        check(n_raw <= capacity, f"sm2mm: {n_raw} raw rows > the merge capacity {capacity}")
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        mm = simplemap_to_metricmap(sm, cfg)  # cold
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        check(knn_launches(counts()) == 0, f"sm2mm {label}: a kNN kernel ran: {counts()}")
        # warm: the keyframes, then the final filters, each timed with a sync
        per_kf = dict(cfg, final_filters=None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mm_w = simplemap_to_metricmap(sm, per_kf)
        torch.cuda.synchronize()
        kf_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        apply_filter_pipeline(filter_pipeline_from_yaml(cfg["final_filters"]), mm_w)
        torch.cuda.synchronize()
        final_s = time.perf_counter() - t0
        prof = profile_window(f"sm2mm {label}, {SM2MM_KEYFRAMES} keyframes",
                              lambda: simplemap_to_metricmap(sm, per_kf), 1, smi, tables,
                              warmups=0)
        syncs = prof["host"].get("cudaStreamSynchronize", 0) + prof["host"].get(
            "cudaDeviceSynchronize", 0)
        got = sm2mm_summary(sm2mm_numpy(mm.layers))
        vg = mm.layers["voxelmap"]
        map_pc = mm.layers["map_points"]
        rows = map_pc.xyz[: int(map_pc.count)]
        occ = lookup_occupancy(vg, rows)
        # occupancy is held to JAX's within 1e-6: a row that close to the
        # threshold may fall on the other side of it
        near = int(((occ - 0.4).abs() <= 1e-6).sum())
        print(f"[sm2mm] {label} on {kind}: {n_raw} raw rows in {SM2MM_KEYFRAMES} keyframes "
              f"(<= {capacity}), map_points {got['map_points']}, voxelmap {got['voxels']} of "
              f"{got['voxel_capacity']} cells used (capacity hit: "
              f"{got['voxels'] == got['voxel_capacity']}), static {got['static']}, dynamic "
              f"{got['dynamic']} ({near} rows within 1e-6 of the 0.4 threshold) [JAX CPU "
              f"reference: {ref['map_points']}, {ref['voxels']}, {ref['static']}, "
              f"{ref['dynamic']}]")
        print(f"[sm2mm] {label}: cold {cold_s:.2f} s; warm {kf_s / SM2MM_KEYFRAMES * 1e3:.1f} ms "
              f"per keyframe on the host clock, {prof['kernels'] / SM2MM_KEYFRAMES:.0f} "
              f"launches and {syncs / SM2MM_KEYFRAMES:.2f} host syncs per keyframe; final "
              f"filters {final_s * 1e3:.1f} ms, on {smi}")
        check(got["map_points"] == ref["map_points"],
              f"sm2mm {label}: {got['map_points']} map points, JAX {ref['map_points']}")
        sum_gap = max(abs(a - b) / max(c, 1.0) for a, b, c in
                      zip(got["map_sum"], ref["map_sum"], ref["map_abs_sum"]))
        check(got["voxels"] == ref["voxels"] and got["voxel_key_sum"] == ref["voxel_key_sum"],
              f"sm2mm {label}: voxels {got['voxels']} key sums {got['voxel_key_sum']}, JAX "
              f"{ref['voxels']} {ref['voxel_key_sum']}")
        occ_gap = max(abs(a[2] - b[2]) for a, b in zip(got["voxel_samples"],
                                                       ref["voxel_samples"]))
        check(all(a[:2] == b[:2] for a, b in zip(got["voxel_samples"], ref["voxel_samples"]))
              and occ_gap <= 1e-6, f"sm2mm {label}: sampled voxels differ (occupancy gap "
              f"{occ_gap})")
        occ_sum_gap = abs(got["voxel_occupancy_sum"] - ref["voxel_occupancy_sum"])
        check(occ_sum_gap <= 1e-6 * got["voxels"],
              f"sm2mm {label}: occupancy sums {got['voxel_occupancy_sum']}, JAX "
              f"{ref['voxel_occupancy_sum']}")
        check(abs(got["static"] - ref["static"]) <= near
              and abs(got["dynamic"] - ref["dynamic"]) <= near,
              f"sm2mm {label}: static / dynamic {got['static']} / {got['dynamic']}, JAX "
              f"{ref['static']} / {ref['dynamic']}, {near} rows near the threshold")
        check(sum_gap <= 1e-6, f"sm2mm {label}: map coordinate sums {sum_gap} apart (relative)")
        desk_gap = max(max(abs(a - b) for a, b in zip(x[1], y[1]))
                       for x, y in zip(got["deskewed_samples"], ref["deskewed_samples"]))
        mean_gap = max(abs(a - b) for a, b in zip(got["deskewed_mean"], ref["deskewed_mean"]))
        print(f"[sm2mm] {label} against JAX: map coordinate sums {sum_gap:.3g} apart (relative), "
              f"voxel keys: count and key sums equal, {SM2MM_SAMPLES} sampled voxels equal with "
              f"occupancy within {occ_gap:.3g}, occupancy sums {occ_sum_gap:.3g} apart; the last "
              f"keyframe's deskewed layer ({got['deskewed_rows']} rows): {SM2MM_SAMPLES} sampled "
              f"rows within {desk_gap:.3g} m, mean within {mean_gap:.3g} m")
        # the precise deskew is held to 1e-5 m; the constant twist's
        # translation divides a float32 1 - cos(phi) by phi, and an ulp of
        # cos there moves a row by up to ~3e-5 m at 10 m/s in either package
        band = 1e-5 if precise else 1e-4
        check(got["deskewed_rows"] == ref["deskewed_rows"] and desk_gap <= band
              and mean_gap <= band, f"sm2mm {label}: deskewed rows {desk_gap} / {mean_gap} m "
              f"from JAX's (band {band})")
        last[label] = mm.layers["deskewed"]
        by_path["knn_bruteforce"][f"sm2mm {label}"] = 0
        if label == "pass 1":
            pass1 = {"simple_map": sm, "summary": got, "raw_rows": n_raw}
    d = (last["pass 1"].xyz - last["pass 2"].xyz)[: int(last["pass 1"].count)].abs().max()
    print(f"[sm2mm] the last keyframe deskewed by the constant twist and by the trajectory: "
          f"rows {float(d):.3g} m apart at most (the IMU's rate is the twist's)")
    return pass1


def yaml_phase(smi, kind, launches, by_path, scene, scans, engine_planar):
    """Phase 11: the repo's three ICP demo YAMLs loaded by the port's
    loader and aligned on the card, and a YAML pipeline of every filter on
    one street frame, each held to YAML_JAX. ``engine_planar``: the engine
    phase's 2D results per pair."""
    from mp2p_icp_tpu_torch.filters import apply_filter_pipeline
    from mp2p_icp_tpu_torch.filters.generator import Observation, apply_generators
    from mp2p_icp_tpu_torch.core.metric_map import MetricMap
    from mp2p_icp_tpu_torch.pipeline import filter_pipeline_from_yaml, load_icp_config_file

    # kitti: the config equals kitti_icp(); the bench pair after its filters
    icp, params, sections = load_icp_config_file(DEMOS / "icp-settings-kitti.yaml")
    check(same_modules(icp, kitti_icp(), {"decimated": "raw"}),
          "icp-settings-kitti.yaml != chip_smoke.kitti_icp()")
    loc, glob = street_pair(scene, 1, 2)
    fl = apply_filter_pipeline(sections["filters"], loc)
    fg = apply_filter_pipeline(sections["filters"], glob)
    res, n_k1, _ = held_align(icp, fl, fg, se3.identity(), params, "kitti YAML",
                              YAML_JAX["kitti"], kind, launches, by_path, tag="yaml")
    err = float(se3.error_log_norm(se3.from_xyz_ypr(*GT), res.optimal_tf))
    print(f"[yaml] icp-settings-kitti.yaml equals kitti_icp() module for module (its matchers "
          f"pair the 'decimated' layers its filter section makes, kitti_icp()'s 'raw'); FirstPoint "
          f"2 m kept {int(fl['decimated'].count)} + {int(fg['decimated'].count)} points; SE(3) "
          f"error {err:.6f}")
    check(err < ERR_LIMIT, f"kitti YAML: SE(3) error {err}")
    by_path["knn_bruteforce"]["yaml kitti align"] = n_k1

    # example1: two ClosestToAverage sections on a bunny-sized pair
    icp, params, sections = load_icp_config_file(DEMOS / "icp-settings-example1.yaml")
    l1, g1 = example1_pair(scene)
    fl = apply_filter_pipeline(sections["filters_local_map"], {"raw": PointCloud.from_numpy(l1)})
    fg = apply_filter_pipeline(sections["filters_global_map"], {"raw": PointCloud.from_numpy(g1)})
    res, n_k1, _ = held_align(icp, fl, fg, se3.identity(), params, "example1 YAML",
                              YAML_JAX["example1"], kind, launches, by_path, tag="yaml")
    err = float(se3.error_log_norm(se3.from_xyz_ypr(*EXAMPLE1_GT), res.optimal_tf))
    check(err < ERR_LIMIT, f"example1 YAML: SE(3) error {err}")
    for side, f in (("local", fl), ("global", fg)):
        got = layer_summary(layers_numpy(f)["decimated"])
        check(got["count"] == YAML_JAX["example1"][f"{side}_decimated"],
              f"example1 {side}: {got['count']} ClosestToAverage rows, JAX "
              f"{YAML_JAX['example1'][side + '_decimated']}")
    print(f"[yaml] example1: ClosestToAverage 0.01 m kept {int(fl['decimated'].count)} + "
          f"{int(fg['decimated'].count)} rows (as JAX); SE(3) error {err:.6f}")
    by_path["knn_bruteforce"]["yaml example1 align"] = n_k1

    # 2D: the demo's generators decode the planar pairs' range scans
    icp, params, sections = load_icp_config_file(DEMOS / "icp-settings-2d-lidar-point2line.yaml")
    check(same_modules(icp, point2line_icp()),
          "icp-settings-2d-lidar-point2line.yaml != chip_smoke.point2line_icp()")
    k1 = 0
    for i, ((g, l, rel), (gp, lp, _), ref) in enumerate(zip(
            planar_range_pairs(), planar_pairs(), YAML_JAX["planar"])):
        maps = []
        for ranges in (l, g):
            mm = MetricMap()
            check(apply_generators(sections["generators"], Observation(**planar_observation(
                ranges)), mm), "the 2D generator did not take the scan")
            maps.append(mm)
        gap = max(float((m.layers["2d_lidar"].xyz[: len(pts)].cpu()
                         - torch.from_numpy(pts)).abs().max())
                  for m, pts in zip(maps, (lp, gp)))
        check(all(int(m.layers["2d_lidar"].count) == len(pts) for m, pts in zip(maps, (lp, gp))),
              f"2D pair {i}: decoded rows != the rendered returns")
        res, n_k1, _ = held_align(icp, maps[0], maps[1], se3.from_xyz_ypr(*planar_guess(rel)),
                                  params, f"2D YAML pair {i}", ref, kind, launches, by_path,
                                  planar=True, tag="yaml")
        k1 += n_k1
        same = gap == 0.0 and torch.equal(res.optimal_tf.t, engine_planar[i].optimal_tf.t)
        print(f"[yaml] 2D pair {i}: the Generator's layers are {gap:.3g} m from the engine "
              f"phase's planar_layers (the float32 polar decode); "
              + ("the align equals the engine phase's to the bit" if gap == 0.0 else
                 "held to the align band of YAML_JAX instead of the engine phase's bits"))
        check(gap > 0.0 or same, f"2D pair {i}: equal layers, aligns differ")
    by_path["knn_bruteforce"][f"yaml 2D, {PLANAR_PAIRS} aligns"] = k1

    # one street frame through a YAML pipeline of every filter
    frame = {"raw": scan_to_pointcloud(scans[0], capacity=1 << 16)}
    filters = filter_pipeline_from_yaml(yaml.safe_load(ALL_FILTERS_YAML)["filters"])
    apply_filter_pipeline(filters, frame)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = apply_filter_pipeline(filters, frame)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = counts()
    check(n["knn_bruteforce"] == 1 and n["knn_streamed"] == n["knn_batched"] == 0,
          f"filter pipeline: one K1 launch (the normals fit) expected, got {n}")
    launches["knn_bruteforce"] += n["knn_bruteforce"]
    by_path["knn_bruteforce"]["yaml filter pipeline (normals k=8)"] = n["knn_bruteforce"]
    ref = YAML_JAX["filters"]
    check(sorted(out) == sorted(ref), f"filter pipeline layers {sorted(out)}, JAX {sorted(ref)}")
    for name in sorted(ref):
        layer = out[name]
        if name == "voxelmap":
            continue  # the keys and occupancy of a voxel layer: the sm2mm phase
        got = layer_summary(layers_numpy({name: layer})[name])
        r = ref[name]
        if name == "gridmap":
            ok = (got["cells"] == r["cells"] and got["known"] == r["known"]
                  and abs(got["occupancy_sum"] - r["occupancy_sum"]) <= 1e-6 * r["known"])
            print(f"[yaml] filter pipeline {name}: {got['known']} cells away from 0.5 of "
                  f"{got['cells']}, occupancy sum {got['occupancy_sum']:.6f} [JAX "
                  f"{r['known']}, {r['occupancy_sum']:.6f}]")
        else:
            gap = max(abs(a - b) / max(c, 1.0) for a, b, c in zip(got["sum"], r["sum"],
                                                                  r["abs_sum"]))
            ch_gap = max([abs(got[k] - r[k]) / max(abs(r[k]), 1.0) for k in r
                          if k.endswith("_sum") and k not in ("abs_sum",) and k in got
                          and not isinstance(r[k], list)] or [0.0])
            ok = (got["count"] == r["count"] and gap <= 1e-6 and ch_gap <= 1e-6
                  and got.get("with_normal") == r.get("with_normal"))
            print(f"[yaml] filter pipeline {name}: {got['count']} rows [JAX {r['count']}], "
                  f"coordinate sums {gap:.3g} apart (relative), channel sums {ch_gap:.3g}"
                  + (f", {got['with_normal']} rows with a normal [JAX {r['with_normal']}]"
                     if "with_normal" in r else ""))
        check(ok, f"filter pipeline: layer {name} differs from the JAX package's")
    # a voxel's rows are summed one by one in sorted order
    # (segment_sums_in_order), so the card's means equal the CPU's bit for bit
    avg = next(f for f in filters if getattr(f, "output_pointcloud_layer", None)
               == "dec_average")
    near_cpu = PointCloud(**{f.name: None if getattr(out["near"], f.name) is None
                             else getattr(out["near"], f.name).cpu()
                             for f in dataclasses.fields(PointCloud)})
    avg_cpu = avg({"near": near_cpu})["dec_average"]
    check(torch.equal(out["dec_average"].xyz.cpu(), avg_cpu.xyz),
          "filter pipeline: the card's VoxelAverage means differ from the CPU's")
    print(f"[yaml] filter pipeline dec_average: the card's {int(avg_cpu.count)} voxel means "
          f"equal the same filter's on the CPU bit for bit")
    print(f"[yaml] filter pipeline of {len(filters)} filters on one street frame "
          f"({int(frame['raw'].count)} returns): {wall * 1e3:.1f} ms warm, 1 K1 launch "
          f"(k=8, {out['dec_first'].capacity} queries), on {smi}")


def printed(fn, argv):
    """(what ``fn(argv)`` prints, its host seconds); echoes the text."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn([str(a) for a in argv])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(rc == 0, f"{fn.__module__}.main{tuple(argv)} returned {rc}")
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"    | {line}")
    return text, seconds


def pose_of_printed(r, device):
    """The pose icp-run printed (translation, quaternion wxyz)."""
    R = se3.quat_to_rot(torch.tensor(r["quat"], dtype=torch.float32, device=device))
    return se3.Pose(R, torch.tensor(r["t"], dtype=torch.float32, device=device))


def decimated_kitti(pc):
    """The kitti YAML's "decimated" layer of a raw cloud (FirstPoint 2 m,
    the raw capacity kept), as kitti-odometry and icp-run make it."""
    from mp2p_icp_tpu_torch.filters import apply_filter_pipeline
    from mp2p_icp_tpu_torch.pipeline import load_icp_config_file

    filters = load_icp_config_file(KITTI_YAML)[2]["filters"]
    return apply_filter_pipeline(filters, {"raw": pc})["decimated"]


def apps_phase(smi, kind, launches, by_path, errs, shapes, pass1):
    """Phase 12: the port's command-line entry points on a KITTI-format
    sequence at HDL-64E geometry, each held to APPS_JAX; their new kernel
    shapes compared with the plain versions and timed into ``shapes``.
    ``pass1``: the sm2mm phase's pass 1 (its simple map and map summary)."""
    from mp2p_icp_tpu_torch.apps import icp_run, kitti_odometry, mm_filter, sm2mm_app, sm_cli
    from mp2p_icp_tpu_torch.eval.trajectory import load_kitti_poses
    from mp2p_icp_tpu_torch.filters import FilterEdgesPlanes
    from mp2p_icp_tpu_torch.filters.sm2mm import SimpleMap
    from mp2p_icp_tpu_torch.io.icplog import load_log
    from mp2p_icp_tpu_torch.io.kitti import load_kitti_bin
    from mp2p_icp_tpu_torch.io.mm import load_mm_file
    from mp2p_icp_tpu_torch.pipeline import load_icp_config_file

    ref = APPS_JAX
    size = {"frames": APPS_FRAMES, "rings": APPS_RINGS, "azimuths": APPS_AZIMUTHS,
            "map_capacity": APPS_MAP_CAPACITY}
    check(all(ref["size"][k] == v for k, v in size.items()),
          f"{APPS_REFERENCE.name} is of another size: {ref['size']}, here {size}")
    # (a) the sequence and the apps' input files
    t0 = time.perf_counter()
    bin_dir, gt_path, scans = write_apps_sequence(APPS_DIR / "sequence", APPS_FRAMES,
                                                  APPS_RINGS, APPS_AZIMUTHS)
    files = write_app_inputs(APPS_DIR / "inputs", scans)
    gt = load_kitti_poses(str(gt_path))
    raw_cap = ref["size"]["raw_capacity"]
    print(f"[apps] {APPS_FRAMES} frames of {APPS_RINGS} rings x {APPS_AZIMUTHS} azimuths "
          f"({APPS_RINGS * APPS_AZIMUTHS} rays a scan, {int(scans[0]['valid'].sum())} returns "
          f"in frame 0, raw capacity {raw_cap}) written as .bin + gt.txt, frames 0-1 as "
          f".xyz.gz, MRPT .mm and .mm.npz, in {time.perf_counter() - t0:.1f} s; the kitti "
          f"YAML's 2 m FirstPoint layer keeps the raw capacity for at most "
          f"{ref['size']['most_2m_voxels']} voxels")
    icp = load_icp_config_file(KITTI_YAML)[0]
    # every iteration of the kitti YAML runs one matcher on one layer pair
    check(all(matcher_calls(icp, i) == i for i in (1, 6, 7, 40, 200)),
          "icp-settings-kitti.yaml: not one matcher call per iteration")

    # (b)-(d) kitti-odometry, its three modes with the demo YAML, and the
    # scan-to-scan and scan-to-map modes with the ground-cropped YAML
    map_path = APPS_DIR / "map.mm.npz"
    mapping = ["--mapping", "--map-capacity", APPS_MAP_CAPACITY, "--out-map"]
    runs = (("sequential", KITTI_YAML, "knn_bruteforce", []),
            ("batched", KITTI_YAML, "knn_batched", ["-B", APPS_BATCH]),
            ("mapping", KITTI_YAML, "knn_bruteforce", mapping + [map_path]),
            ("cropped_sequential", files["cropped"], "knn_bruteforce", []),
            ("cropped_mapping", files["cropped"], "knn_bruteforce",
             mapping + [APPS_DIR / "map_cropped.mm.npz"]))
    true_step = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1)
    motion = {}
    for mode, config, kernel, extra in runs:
        r = ref[mode]
        poses_path = APPS_DIR / f"poses_{mode}.txt"
        torch.cuda.synchronize()
        reset_counts()
        text, seconds = printed(kitti_odometry.main, [
            "--bin-dir", bin_dir, "-c", config, "--gt-poses", gt_path,
            "--out-poses", poses_path] + extra)
        n = counts()
        got = kitti_odometry_printed(text)
        poses = load_kitti_poses(str(poses_path))
        ate, rt, rr = trajectory_errors(poses, gt)
        calls = sum(got["batch_iterations"]) if mode == "batched" else got["iterations"]
        others = {k: v for k, v in n.items() if k.startswith("knn_") and k != kernel}
        check(n[kernel] == calls and calls > 0 and not any(others.values()),
              f"kitti-odometry {mode}: launches {n}, matcher calls {calls} of {kernel}")
        launches[kernel] += n[kernel]
        by_path[kernel][f"kitti-odometry {mode}, {APPS_FRAMES} frames"] = n[kernel]
        count_own(launches, by_path, n, f"kitti-odometry {mode}, {APPS_FRAMES} frames")
        check(poses.shape == (APPS_FRAMES, 4, 4) and np.isfinite(poses).all(),
              f"kitti-odometry {mode}: poses {poses.shape} not finite")
        ms = 1e3 / got["scans_per_s"]
        ref_its = (f"{sum(r['iterations'])} iterations" if "iterations" in r
                   else "iterations not recorded")
        print(f"[apps] kitti-odometry {mode} ({pathlib.Path(config).name}) on {kind}: ATE "
              f"{ate:.4f} m, RPE {rt:.4f} m / {rr:.5f} rad, {got['iterations']} ICP iterations "
              f"over {APPS_FRAMES - 1} frames ({got['iterations'] / (APPS_FRAMES - 1):.2f} a "
              f"frame), {ms:.1f} ms per frame (host clock, the app's own timer; {seconds:.1f} s "
              f"for the whole call); {n[kernel]} {kernel} launches == matcher calls, no other "
              f"kNN kernel [JAX CPU reference: ATE {r['ate_m']:.4f} m, RPE "
              f"{r['rpe_trans']:.4f} m / {r['rpe_rot']:.5f} rad, {ref_its}, "
              f"{1e3 / r['scans_per_s']:.1f} ms per frame on a CPU] on {smi}")
        check(ate <= max(1.5 * r["ate_m"], r["ate_m"] + 0.01)
              and rt <= max(1.5 * r["rpe_trans"], r["rpe_trans"] + 0.01),
              f"kitti-odometry {mode}: ATE {ate} m / RPE {rt} m outside max(1.5x, +0.01 m) "
              f"of JAX's {r['ate_m']} / {r['rpe_trans']}")
        # each pair's relative pose against the JAX package's: the align
        # band. A scan-to-map run amplifies the pairings that the JAX
        # package's approximate kNN distances turn (ROADMAP C), so its pairs
        # are held to the port's own run on the CPU (the plain kNN) and its
        # trajectory to JAX's by the bands above
        gaps = pair_gaps(poses, kitti_rows_to_poses(r["poses"]))
        step = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
        motion[mode] = step[WARM_FRAMES:].mean()
        print(f"[apps] kitti-odometry {mode}: frame-to-frame poses within {gaps.max():.3g} of "
              f"JAX's (median {np.median(gaps):.3g}); estimated motion {step.mean():.3f} m a "
              f"frame against the true {true_step.mean():.3f} m")
        if "--mapping" in extra:
            cpu = ref["port_cpu"][mode]
            gaps = pair_gaps(poses, kitti_rows_to_poses(cpu["poses"]))
            print(f"[apps] kitti-odometry {mode}: frame-to-frame poses within {gaps.max():.3g} of "
                  f"the port's on the CPU (median {np.median(gaps):.3g}; its map "
                  f"{cpu['map_points']} points, {sum(cpu['iterations'])} iterations)")
        check(gaps.max() < 5e-3, f"kitti-odometry {mode}: a pair's pose is {gaps.max()} from "
              f"its reference's (frame {int(gaps.argmax()) + 1})")
        if mode == "batched":
            print(f"[apps] kitti-odometry -B {APPS_BATCH}: the slowest pair of each batch "
                  f"{got['batch_iterations']} [JAX CPU reference: {r['batch_iterations']}]")
        if "--out-map" in extra:
            out_map = extra[-1]
            saved = load_mm_file(out_map).layers["map"]
            n_map = int(saved.count)
            print(f"[apps] --out-map {out_map.name}: {n_map} map points of capacity "
                  f"{saved.capacity} [JAX CPU reference: {r['map_points']}]")
            check(saved.capacity == APPS_MAP_CAPACITY
                  and abs(n_map - r["map_points"]) <= 0.02 * r["map_points"],
                  f"kitti-odometry {mode}: {n_map} map points, JAX {r['map_points']}")
    # the demo YAML's stall is the ground's: cropped away, the drive is
    # tracked once the constant-velocity guess has caught up
    true_mean = true_step[WARM_FRAMES:].mean()
    print(f"[apps] kitti-odometry, frames {WARM_FRAMES + 1} on: the demo YAML estimates "
          f"{motion['sequential']:.3f} m a frame (scan to scan) and {motion['mapping']:.3f} m "
          f"(scan to map), the ground-cropped YAML {motion['cropped_sequential']:.3f} m and "
          f"{motion['cropped_mapping']:.3f} m, against the true {true_mean:.3f} m")
    check(all(abs(motion[m] - true_mean) < 0.05 * true_mean
              for m in ("cropped_sequential", "cropped_mapping")),
          f"kitti-odometry: the ground-cropped YAML does not track the drive: {motion}")

    # the kitti paths' kernel shapes: the decimated layer (its capacity is
    # the raw one) against the previous frame's (K1) and 8 such pairs (K2);
    # the mapping mode's against the crop of the final map at the last pose
    dec = [decimated_kitti(load_kitti_bin(str(bin_dir / f"{i:06d}.bin"), capacity=raw_cap))
           for i in range(APPS_BATCH + 1)]
    q1, p1 = sentinel_padded(dec[1], 1.0e8), sentinel_padded(dec[0], -1.0e8)
    qb = torch.stack([sentinel_padded(d, 1.0e8) for d in dec[1:]])
    pb = torch.stack([sentinel_padded(d, -1.0e8) for d in dec[:-1]])
    micp, mparams, _ = load_icp_config_file(KITTI_YAML)
    micp.matchers = [dataclasses.replace(m, layer_matches=tuple(
        dataclasses.replace(lm, global_layer="map") for lm in m.layer_matches))
        for m in micp.matchers]
    last = APPS_FRAMES - 1
    dec_last = decimated_kitti(load_kitti_bin(str(bin_dir / f"{last:06d}.bin"), capacity=raw_cap))
    pose_last = pose_of(load_kitti_poses(str(APPS_DIR / "poses_mapping.txt"))[last])
    crop = micp._crop_globals(mparams, {"map": load_mm_file(map_path).layers["map"]},
                              {"decimated": dec_last}, pose_last)[0]["map"]
    qm, pm = sentinel_padded(dec_last, 1.0e8), sentinel_padded(crop, -1.0e8)
    # the last field: the plain version's timed calls (K2's takes 8 x 1.7 s)
    k1, k2 = (nnb.knn_sweep, nnb.knn_plain), (nnb.knn_sweep_batched, nnb.knn_plain_batched)
    new_rows = (
        ("knn_bruteforce", *k1, "kitti-odometry / icp-run: the decimated KITTI layer", 1, q1,
         p1, 3),
        ("knn_bruteforce", *k1, "kitti-odometry --mapping: against the map's crop", 1, qm, pm,
         3),
        ("knn_batched", *k2, f"kitti-odometry -B {APPS_BATCH}", APPS_BATCH, qb, pb, 1),
    )
    for name, kernel, plain, label, B, q, p, plain_reps in new_rows:
        Q, C = q.shape[-2], p.shape[-2]
        errs[name].append(compare(f"{name} {B}x{Q}x{C} k=1 ({label}, "
                                  f"{int((q[..., 0].abs() < 1e7).sum())} valid queries, "
                                  f"{int((p[..., 0].abs() < 1e7).sum())} valid points)",
                                  kernel, plain, q, p, 1))
        # as the path calls it: with the counts of the front end
        n = (row_counts(q), row_counts(p))
        launch_line(B, Q, C, 1, n)
        errs[name].append(compare(f"{name} {B}x{Q}x{C} k=1 ({label}) counted", kernel, plain,
                                  q, p, 1, *n))
        g_times = graph_ms(lambda: kernel(q, p, 1, *n), replays=3 if B > 1 else 7)
        shapes[name].append(kernel_row(
            name, label, B, Q, C, 1, lambda: kernel(q, p, 1, *n), lambda: plain(q, p, 1, *n),
            q, p, g_times, smi, plain_reps=plain_reps, counts=n))
    del qb, pb
    torch.cuda.empty_cache()

    # (e) icp-run on frames 1 (local) and 0 (global), from both formats
    results = {}
    for fmt, what in (("xyz", ".xyz.gz"), ("mm", "MRPT binary .mm")):
        r = ref["icp_run"][fmt]
        log_path = APPS_DIR / f"icp_run_{fmt}.icplog.npz"
        torch.cuda.synchronize()
        reset_counts()
        text, seconds = printed(icp_run.main, [
            "--input-local", files[f"{fmt}1"], "--input-global", files[f"{fmt}0"],
            "-c", KITTI_YAML, "--out-log", log_path, "--profiler"])
        n = counts()
        got = icp_run_printed(text)
        calls = matcher_calls(icp, got["iterations"])
        check(n["knn_bruteforce"] == calls and n["knn_streamed"] == n["knn_batched"] == 0,
              f"icp-run {fmt}: launches {n}, matcher calls {calls}")
        launches["knn_bruteforce"] += n["knn_bruteforce"]
        by_path["knn_bruteforce"][f"icp-run, {what}"] = n["knn_bruteforce"]
        count_own(launches, by_path, n, f"icp-run, {what}")
        dev = default_device()
        pose = pose_of_printed(got, dev)
        gap = float(se3.error_log_norm(pose_of_printed(r, dev), pose))
        log = load_log(log_path)
        log_gap = float((log["result"].t - pose.t).abs().max())
        print(f"[apps] icp-run from {what} on {kind}: {got['iterations']} iterations, "
              f"{got['termination']}, quality {got['quality']}, {got['pairings']} pairings, "
              f"pose gap to JAX {gap:.3g}, {n['knn_bruteforce']} K1 launches, {seconds:.2f} s for "
              f"the call [JAX CPU reference: {r['iterations']}, {r['termination']}, "
              f"{r['quality']}]; --out-log loads, its pose within {log_gap:.2g} m of the printed")
        check(got["termination"] == r["termination"]
              and iterations_agree(got["iterations"], r["iterations"]),
              f"icp-run {fmt}: {got['iterations']} {got['termination']}, JAX {r}")
        check(gap < 5e-3, f"icp-run {fmt}: pose {gap} from the JAX reference's")
        check(log["meta"]["n_iterations"] == got["iterations"] and log_gap < 1e-5,
              f"icp-run {fmt}: the log disagrees with the printed result")
        results[fmt] = pose
    gap = float(se3.error_log_norm(results["xyz"], results["mm"]))
    print(f"[apps] icp-run: the .xyz.gz (6 decimals) and .mm (float32) inputs give poses "
          f"{gap:.3g} apart")

    # (f) mm-filter: the structured filters on frame 0
    out_path = APPS_DIR / "filtered.mm.npz"
    torch.cuda.synchronize()
    reset_counts()
    _, seconds = printed(mm_filter.main, ["-i", files["npz0"], "-o", out_path,
                                          "-p", files["filters"]])
    check(knn_launches(counts()) == 0, f"mm-filter: a kNN kernel ran: {counts()}")
    out_mm = load_mm_file(out_path)
    got = mm_filter_summary(out_mm)
    raw = load_mm_file(files["npz0"]).layers["raw"]
    r = ref["mm_filter"]
    check(sorted(got) == sorted(r), f"mm-filter layers {sorted(got)}, JAX {sorted(r)}")
    print(f"[apps] mm-filter on {kind}: {len(got) - 1} layers of frame 0 in {seconds:.2f} s "
          f"(load, 6 filters, save)")
    # the layers no class threshold decides: count and sums as JAX's
    for name in sorted(r):
        if name in EDGES_PLANES_LAYERS or name == "planes":
            continue
        a, b = got[name], r[name]
        gap = max(abs(x - y) for x, y in zip(a["sum"], b["sum"]))
        rel = gap / max(max(b["abs_sum"]), 1.0)
        ch = max([abs(a[k] - b[k]) / max(abs(b[k]), 1.0) for k in b
                  if k.endswith("_sum") and k != "abs_sum" and k in a] or [0.0])
        print(f"[apps] mm-filter {name}: {a['count']} rows [JAX {b['count']}], coordinate "
              f"sums {rel:.3g} apart (relative), channel sums {ch:.3g}")
        check(a["count"] == b["count"] and rel <= 1e-6 and ch <= 1e-6,
              f"mm-filter: layer {name} differs from the JAX package's")
    # FilterEdgesPlanes' layers and planes, row for row
    near_voxels, near_rows = held_edges_planes(
        FilterEdgesPlanes(voxel_filter_resolution=0.5), raw, out_mm, ref["mm_filter_rows"],
        "mm-filter")
    print(f"[apps] mm-filter FilterEdgesPlanes: {near_voxels} threshold voxels ({near_rows} "
          f"rows) within {EIGEN_BAND} * l2 of a class threshold; only their rows may differ")

    # (g) sm2mm and sm-cli on the sm2mm phase's pass 1, saved to disk
    sm_path, mm_path, cut_path = (APPS_DIR / n for n in ("street.sm.npz", "street.mm.npz",
                                                           "street_cut.sm.npz"))
    pass1["simple_map"].save(sm_path)
    torch.cuda.synchronize()
    reset_counts()
    _, seconds = printed(sm2mm_app.main, ["-i", sm_path, "-o", mm_path, "-p",
                                          DEMOS / "sm2mm_voxelmap_static_dynamic.yaml"])
    check(knn_launches(counts()) == 0, f"sm2mm: a kNN kernel ran: {counts()}")
    got = sm2mm_summary(sm2mm_numpy(load_mm_file(mm_path).layers))
    want = pass1["summary"]
    keys = ("map_points", "voxels", "voxel_key_sum", "static", "dynamic")
    print(f"[apps] sm2mm on the file of the sm2mm phase's pass 1 on {kind}: map_points "
          f"{got['map_points']}, voxels {got['voxels']}, static {got['static']}, dynamic "
          f"{got['dynamic']} [the phase: {[want[k] for k in keys]}], {seconds:.1f} s")
    check(all(got[k] == want[k] for k in keys), "sm2mm: the map differs from the sm2mm phase's")
    text, _ = printed(sm_cli.main, ["info", sm_path])
    info = dict(re.findall(r"^(keyframes|observations|total points): (\d+)$", text, re.M))
    n_kf = len(pass1["simple_map"].keyframes)
    check(int(info["keyframes"]) == n_kf and int(info["total points"]) == pass1["raw_rows"],
          f"sm-cli info: {info}, want {n_kf} keyframes and {pass1['raw_rows']} points")
    lo, hi = n_kf // 4, n_kf // 2
    printed(sm_cli.main, ["cut", sm_path, "--from-index", lo, "--to-index", hi, "-o", cut_path])
    cut = SimpleMap.load(cut_path).keyframes
    check(len(cut) == hi - lo and all(torch.equal(a.pose.t, b.pose.t) for a, b in zip(
        cut, pass1["simple_map"].keyframes[lo:hi])), f"sm-cli cut: not keyframes {lo}-{hi - 1}")
    print(f"[apps] sm-cli info: {n_kf} keyframes, {info['total points']} points (as the "
          f"phase's map); cut {lo}:{hi} -> {hi - lo} keyframes with the same poses")
    # the inputs go (they are made again from the seed); the outputs stay
    for path in (APPS_DIR / "sequence", APPS_DIR / "inputs", sm_path, cut_path, mm_path):
        shutil.rmtree(path) if path.is_dir() else path.unlink()
    kept = sorted(APPS_DIR.iterdir())
    print(f"[apps] kept under {APPS_DIR.relative_to(REPO)}: "
          f"{sum(f.stat().st_size for f in kept) / 2**20:.1f} MiB in {len(kept)} files "
          f"({', '.join(f.name for f in kept)}); the sequence and the input files deleted")
    return scans


def ulps_apart(a, b):
    """|a - b| in units in the last place of float32 arrays (0 where equal)."""
    ia, ib = (np.asarray(x, np.float32).view(np.int32).astype(np.int64) for x in (a, b))
    ia = np.where(ia < 0, np.int64(-(2**31)) - ia, ia)  # sign-magnitude to a monotone line
    ib = np.where(ib < 0, np.int64(-(2**31)) - ib, ib)
    return np.abs(ia - ib)


def grid_rows_explained(grid, q, rg, rb, k_per_cell):
    """Rows where nn_search and the exact kNN differ, by cause: (ties: the
    same distances in another order of indices, duplicates: a bucket's rows
    gathered twice for two colliding cells, overflow: a bucket with more
    rows than ``k_per_cell``, other). Numpy in, counts out."""
    from mp2p_icp_tpu_torch.ops.voxel_hash import NEIGHBOR_OFFSETS, cell_coords, hash_cells

    differ = (rg["idx"] != rb["idx"]).any(1) | (rg["valid"] != rb["valid"]).any(1)
    rows = np.nonzero(differ)[0]
    dup = np.array([len(set(r[v].tolist())) < int(v.sum()) for r, v in
                    zip(rg["idx"][rows], rg["valid"][rows])], bool)
    same_d = np.array([np.array_equal(a[va], b[vb]) for a, b, va, vb in zip(
        rg["dist_sq"][rows], rb["dist_sq"][rows], rg["valid"][rows], rb["valid"][rows])], bool)
    cells = cell_coords(torch.from_numpy(q[rows]), grid.cell_size)
    nh = hash_cells(cells[:, None, :] + torch.from_numpy(NEIGHBOR_OFFSETS).to(torch.int32),
                    grid.bucket_count.shape[0])
    over = (grid.bucket_count.cpu()[nh] > k_per_cell).any(1).numpy()
    ties = same_d & ~dup
    other = ~(ties | dup | over)
    return {"rows": len(rows), "ties": int(ties.sum()), "duplicates": int(dup.sum()),
            "overflow": int((over & ~dup & ~ties).sum()), "other": int(other.sum())}


def tools_phase(smi, kind, launches, by_path, errs, shapes, scans, pass1):
    """Phase 13: the map tools, held to TOOLS_JAX (the JAX package's apps
    on the CPU, scripts/torch_tools_reference.py): rawlog-filter over the
    apps phase's sequence (``scans``) and sm-filter over the sm2mm phase's
    pass-1 simple map with TOOLS_YAML, mm-georef on the apps phase's map,
    the converters on frame 0, the viewers on that map and an icp-run log,
    nn_search over a HashGrid of a decimated frame against K1, every call in
    a Profiler span. The new K1 shape is compared with its plain version
    and timed into ``shapes``. Inputs and outputs under TOOLS_DIR are
    deleted at the end but for the card's HTML pages."""
    from mp2p_icp_tpu_torch import filters as filters_pkg
    from mp2p_icp_tpu_torch.apps import (icp_log_viewer, kitti2mm, mm2txt, mm_georef, mm_info,
                                         mm_viewer, rawlog_filter, sm_filter, txt2mm)
    from mp2p_icp_tpu_torch.core import geodesy
    from mp2p_icp_tpu_torch.filters.sm2mm import SimpleMap
    from mp2p_icp_tpu_torch.io.mm import load_mm_file
    from mp2p_icp_tpu_torch.io.rawlog import Rawlog
    from mp2p_icp_tpu_torch.ops.nn import nn_search
    from mp2p_icp_tpu_torch.ops.voxel_hash import build_hash_grid
    from mp2p_icp_tpu_torch.utils import Profiler

    ref = TOOLS_JAX
    size = {"frames": APPS_FRAMES, "rings": APPS_RINGS, "azimuths": APPS_AZIMUTHS,
            "keyframes": SM2MM_KEYFRAMES}
    check(all(ref["size"][k] == v for k, v in size.items()),
          f"{TOOLS_REFERENCE.name} is of another size: {ref['size']}, here {size}")
    prof = Profiler()
    TOOLS_DIR.mkdir(parents=True, exist_ok=True)
    d = TOOLS_DIR
    with prof.scope("tools.inputs"):
        write_rawlog(d / "in.rawlog.npz", scans)
        txt, bin_ = tools_inputs_frame0(scans[0], d)
        (d / "tools.yaml").write_text(TOOLS_YAML)
        (d / "georef.yaml").write_text(yaml.safe_dump({"georeferencing": GEOREF}))
        pass1["simple_map"].save(d / "in.sm.npz")
    print(f"[tools] inputs: {APPS_FRAMES} frames as a .rawlog.npz "
          f"({(d / 'in.rawlog.npz').stat().st_size / 2**20:.1f} MiB), frame 0 as .txt and "
          f".bin, the sm2mm phase's pass-1 simple map ({len(pass1['simple_map'].keyframes)} "
          f"keyframes) as .sm.npz")

    # (a) rawlog-filter at full width: K1 k=8 once a frame (the normals fit)
    record = []
    torch.cuda.synchronize()
    reset_counts()
    with prof.scope("tools.rawlog_filter"), captured_layers(filters_pkg, record):
        _, seconds = printed(rawlog_filter.main, ["-i", d / "in.rawlog.npz", "-o",
                                                  d / "out.rawlog.npz", "-p", d / "tools.yaml",
                                                  "-v", "QUIET"])
    n = counts()
    check(n["knn_bruteforce"] == APPS_FRAMES and n["knn_streamed"] == n["knn_batched"] == 0,
          f"rawlog-filter: launches {n}, want one K1 a frame ({APPS_FRAMES})")
    launches["knn_bruteforce"] += n["knn_bruteforce"]
    by_path["knn_bruteforce"][f"rawlog-filter, {APPS_FRAMES} frames (normals k=8)"] = n["knn_bruteforce"]
    got = rawlog_summary(Rawlog.load(str(d / "out.rawlog.npz")))
    want = ref["rawlog"]
    check(len(got) == len(want) == APPS_FRAMES, f"rawlog-filter: {len(got)} frames")
    gap = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        check([o["label"] for o in a] == [o["label"] for o in b] and len(a) == 4,
              f"rawlog-filter frame {i}: entries {[o['label'] for o in a]}, JAX "
              f"{[o['label'] for o in b]}")
        for x, y in zip(a, b):
            check(x["count"] == y["count"], f"rawlog-filter frame {i} {x['label']}: "
                  f"{x['count']} rows, JAX {y['count']}")
            gap = max([gap] + [abs(u - v) / max(w, 1.0) for u, v, w in zip(
                x["sum"], y["sum"], y["abs_sum"])] + [abs(x[c] - y[c]) / max(abs(y[c]), 1.0)
                                                      for c in y if c.endswith("_sum")
                                                      and c != "abs_sum"])
    check(gap <= 1e-6, f"rawlog-filter: sums {gap} apart (relative)")
    # the normals its run fitted (the file keeps none)
    fit = [normals_summary(r) for r in record]
    wn = [a["with_normal"] - b["with_normal"] for a, b in zip(fit, ref["rawlog_normals"])]
    rows_far = {}
    for key, packed in ref["rawlog_normal_rows"].items():
        r = record[int(key)]
        far = normals_beyond_band(r["normals"][: int(r["count"])], unpack_normals(packed))
        rows_far[key] = (int(far.sum()), int(far.size))
        check(far.mean() <= NORMALS_SHARE, f"rawlog-filter frame {key}: {far.mean():.2%} of "
              f"the normals beyond {NORMALS_BAND} of JAX's")
    check(all(abs(g) <= 0.005 * f["count"] for g, f in zip(wn, fit)),
          f"rawlog-filter: rows with a normal differ from JAX's by {wn}")
    decimated = [o["count"] for fr in got for o in fr if o["label"] == "out_decimated"]
    print(f"[tools] rawlog-filter on {kind}: {APPS_FRAMES} frames, {seconds * 1e3 / APPS_FRAMES:.1f} "
          f"ms a frame (host clock: load, generator, range, FirstPoint 0.5 m, normals, save; "
          f"{seconds:.1f} s the call), 4 entries a frame (the observation, out_decimated, "
          f"out_ranged, out_raw), rows exact and sums {gap:.3g} apart (relative) as JAX's; "
          f"decimated {min(decimated)}-{max(decimated)} rows; {n['knn_bruteforce']} K1 launches, no "
          f"K2/K3; rows with a normal minus JAX's per frame in [{min(wn)}, {max(wn)}]; "
          + ", ".join(f"frame {k}: {a} of {b} normals beyond {NORMALS_BAND} of JAX's"
                      for k, (a, b) in rows_far.items()) + f" on {smi}")

    # the new K1 shape: the decimated layer against itself, k=8
    dev = default_device()
    layer0 = PointCloud(xyz=torch.from_numpy(record[0]["xyz"]).to(dev),
                        count=torch.from_numpy(record[0]["count"]).to(dev))
    q, p = sentinel_padded(layer0, 1.0e8), sentinel_padded(layer0, -1.0e8)
    Q = q.shape[0]
    errs["knn_bruteforce"].append(compare(
        f"K1 {Q}x{Q} k=8 (rawlog-filter normals, {int(layer0.count)} valid)", nnb.knn_sweep,
        nnb.knn_plain, q, p, 8))
    n = (row_counts(q), row_counts(p))  # as the normals filter's front end passes them
    launch_line(1, Q, Q, 8, n)
    errs["knn_bruteforce"].append(compare(f"K1 {Q}x{Q} k=8 (rawlog-filter normals) counted",
                                     nnb.knn_sweep, nnb.knn_plain, q, p, 8, *n))
    g_times = graph_ms(lambda: nnb.knn_sweep(q, p, 8, *n), replays=3)
    shapes["knn_bruteforce"].append(kernel_row(
        "knn_bruteforce", "rawlog-filter normals", 1, Q, Q, 8,
        lambda: nnb.knn_sweep(q, p, 8, *n), lambda: nnb.knn_plain(q, p, 8, *n), q, p, g_times,
        smi, plain_reps=1, counts=n))
    del q, p
    torch.cuda.empty_cache()

    # (b) sm-filter on the pass-1 simple map
    record_sm = []
    torch.cuda.synchronize()
    reset_counts()
    with prof.scope("tools.sm_filter"), captured_layers(filters_pkg, record_sm):
        text, seconds = printed(sm_filter.main, ["-i", d / "in.sm.npz", "-o", d / "out.sm.npz",
                                                 "-p", d / "tools.yaml", "--output-layer",
                                                 TOOLS_LAYER])
    n = counts()
    n_kf = len(pass1["simple_map"].keyframes)
    check(n["knn_bruteforce"] == n_kf and n["knn_streamed"] == n["knn_batched"] == 0,
          f"sm-filter: launches {n}, want one K1 a keyframe ({n_kf})")
    launches["knn_bruteforce"] += n["knn_bruteforce"]
    by_path["knn_bruteforce"][f"sm-filter, {n_kf} keyframes (normals k=8)"] = n["knn_bruteforce"]
    points = simplemap_summary(SimpleMap.load(str(d / "out.sm.npz")))
    check(points == ref["sm_filter"]["points"],
          f"sm-filter: keyframe points {points}, JAX {ref['sm_filter']['points']}")
    check(text.replace(str(d / "out.sm.npz"), "OUT/out.sm.npz") == ref["sm_filter"]["line"],
          f"sm-filter printed {text!r}, JAX {ref['sm_filter']['line']!r}")
    print(f"[tools] sm-filter on {kind}: {n_kf} keyframes, {seconds * 1e3 / n_kf:.1f} ms a "
          f"keyframe (host clock, load and save included), decimated rows per keyframe as "
          f"JAX's ({min(points)}-{max(points)}), the output loads; {n['knn_bruteforce']} K1 launches")

    # (c) mm-georef on the apps phase's map
    src, geo, enu = APPS_DIR / "map.mm.npz", d / "geo.mm.npz", d / "enu.mm.npz"
    with prof.scope("tools.mm_georef"):
        printed(mm_georef.main, [src, "--inject", d / "georef.yaml", "-o", geo])
        printed(mm_georef.main, [geo, "--extract", d / "again.yaml"])
        lines = {"print": printed(mm_georef.main, [geo])[0],
                 "geodetic_to_map": printed(mm_georef.main, [geo, "--geodetic-to-map",
                                                             GEOREF_FIX])[0],
                 "map_to_geodetic": printed(mm_georef.main, [geo, "--map-to-geodetic",
                                                             GEOREF_POINT])[0]}
        _, seconds = printed(mm_georef.main, [geo, "--to-enu", "-o", enu])
    check(yaml.safe_load((d / "again.yaml").read_text()) == {"georeferencing": GEOREF},
          "mm-georef: --extract after --inject differs from the injected YAML")
    check(lines == ref["georef"], f"mm-georef printed {lines}, JAX {ref['georef']}")
    before, after = load_mm_file(str(geo), device="cpu"), load_mm_file(str(enu), device="cpu")
    ulp_rows, n_rows = 0, 0
    for name, layer in before.layers.items():
        if not isinstance(layer, PointCloud):
            continue
        k = int(layer.count)
        host = geodesy.map_to_enu(layer.xyz[:k].numpy().astype(np.float64),
                                  before.georeferencing).astype(np.float32)
        u = ulps_apart(after.layers[name].xyz[:k].numpy(), host)
        check(u.max() <= 1 and torch.equal(after.layers[name].xyz[k:], layer.xyz[k:]),
              f"mm-georef --to-enu {name}: {u.max()} ulps from the host's geodesy")
        ulp_rows += int((u.max(1) > 0).sum())
        n_rows += k
    check(after.georeferencing.t_enu_to_map_xyz == (0.0, 0.0, 0.0), "--to-enu: not identity")
    print(f"[tools] mm-georef on {src.name}: --inject / --extract give the injected anchor "
          f"back; --geodetic-to-map {GEOREF_FIX} -> {lines['geodetic_to_map'].strip()}, "
          f"--map-to-geodetic {GEOREF_POINT} -> {lines['map_to_geodetic'].strip()} (JAX's lines); "
          f"--to-enu rewrote {n_rows} rows on {kind} in {seconds:.2f} s, {ulp_rows} of them "
          f"1 ulp from the host's float64 geodesy, the rest equal")

    # (d) the converters on frame 0
    with prof.scope("tools.converters"), contextlib.chdir(d):
        printed(txt2mm.main, ["-i", txt, "-o", d / "frame0_txt.mm.npz", "-f", "xyzirt"])
        printed(mm2txt.main, [d / "frame0_txt.mm.npz"])
        printed(kitti2mm.main, ["-i", bin_, "-o", d / "frame0.mm.npz"])
        info, _ = printed(mm_info.main, [d / "frame0.mm.npz"])
    back = np.loadtxt(d / "frame0_txt_raw.txt", dtype=np.float32)
    check(np.array_equal(back, np.loadtxt(txt, dtype=np.float32)),
          "txt2mm -> mm2txt: the columns differ from the input's")
    rows = np.fromfile(bin_, np.float32).reshape(-1, 4)
    scan = load_mm_file(str(d / "frame0.mm.npz"), device="cpu").layers["raw"]
    check(np.array_equal(scan.to_numpy(), rows[:, :3])
          and np.array_equal(scan.intensity[: len(rows)].numpy(), rows[:, 3]),
          "kitti2mm: the layer differs from the .bin rows")
    check(info == ref["mm_info"], f"mm-info printed {info!r}, JAX {ref['mm_info']!r}")
    print(f"[tools] txt2mm -f xyzirt -> mm2txt and kitti2mm -> mm-info on frame 0 "
          f"({len(rows)} rows): the columns come back equal; mm-info: {info.strip()} (JAX's)")

    # (e) the viewers: the card's run against the CPU's
    log = APPS_DIR / "icp_run_xyz.icplog.npz"
    pages = {}
    for tag, dev_name in (("card", str(default_device())), ("cpu", "cpu")):
        with prof.scope(f"tools.viewers ({tag})"):
            mm_text, _ = printed(mm_viewer.main, [src, "--html", d / f"map_{tag}.html",
                                                  "--device", dev_name])
            log_text, _ = printed(icp_log_viewer.main, [log, "--html", d / f"log_{tag}.html",
                                                        "--device", dev_name])
        pages[tag] = (mm_text.replace(f"_{tag}.html", ".html"),
                      log_text.replace(f"_{tag}.html", ".html"),
                      (d / f"map_{tag}.html").read_bytes(), (d / f"log_{tag}.html").read_bytes())
    check(pages["card"] == pages["cpu"], "the viewers' text or HTML differ between the card "
          "and the CPU")
    print(f"[tools] mm-viewer --html on {src.name} ({len(pages['card'][2]) / 2**20:.1f} MiB) "
          f"and icp-log-viewer --html + text on {log.name} ({len(pages['card'][1].splitlines())} "
          f"lines): byte for byte the pages and lines of --device cpu")

    # (f) nn_search over a HashGrid of decimated frame 0, queries frame 1's
    layer1 = record[1]
    q_cpu = torch.from_numpy(layer1["xyz"])
    qv_cpu = torch.arange(q_cpu.shape[0]) < int(layer1["count"])
    p_cpu, pv_cpu = layer0.xyz.cpu(), layer0.valid_mask().cpu()
    q, qv, p, pv = q_cpu.to(dev), qv_cpu.to(dev), p_cpu.to(dev), pv_cpu.to(dev)
    with prof.scope("tools.nn_search"):
        grid = build_hash_grid(p, pv, NN_GRID_CELL)
        torch.cuda.synchronize()
    grid_cpu = build_hash_grid(p_cpu, pv_cpu, NN_GRID_CELL)
    check(all(torch.equal(getattr(grid, f).cpu(), getattr(grid_cpu, f)) for f in (
        "points_sorted", "order", "valid_sorted", "bucket_start", "bucket_count")),
          "build_hash_grid: the card's grid differs from the CPU's")
    for k in (1, 8):
        t0 = time.perf_counter()
        rg = nn_search(grid, q, qv, k=k, k_per_cell=NN_GRID_PER_CELL,
                       max_radius_sq=NN_GRID_RADIUS_SQ)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        rc = nn_search(grid_cpu, q_cpu, qv_cpu, k=k, k_per_cell=NN_GRID_PER_CELL,
                       max_radius_sq=NN_GRID_RADIUS_SQ)
        check(all(torch.equal(getattr(rg, f).cpu(), getattr(rc, f)) for f in rg._fields),
              f"nn_search k={k}: the card's result differs from the CPU's")
        reset_counts()
        rb = nnb.knn_bruteforce(q, qv, p, pv, k=k, max_radius_sq=NN_GRID_RADIUS_SQ)
        torch.cuda.synchronize()
        n = counts()
        check(n["knn_bruteforce"] == 1 and knn_launches(n) == 1, f"nn_search's reference: {n}")
        launches["knn_bruteforce"] += 1
        by_path["knn_bruteforce"][f"nn_search against K1, k={k}"] = 1
        a = {f: getattr(rg, f).cpu().numpy() for f in rg._fields}
        b = {f: getattr(rb, f).cpu().numpy() for f in ("idx", "dist_sq", "valid")}
        same = (a["idx"] == b["idx"]) & a["valid"] & b["valid"]
        u = ulps_apart(a["dist_sq"][same], b["dist_sq"][same])
        why = grid_rows_explained(grid, q_cpu.numpy(), a, b, NN_GRID_PER_CELL)
        check(u.max(initial=0) <= 1, f"nn_search k={k}: d2 {u.max()} ulps from K1's")
        check(why["other"] == 0, f"nn_search k={k}: rows that differ from K1's unexplained: "
              f"{why}")
        print(f"[tools] nn_search k={k} over a HashGrid (cell {NN_GRID_CELL} m, "
              f"{grid.bucket_start.shape[0]} buckets, at most {int(grid.bucket_count.max())} "
              f"rows a bucket) of decimated frame 0 ({int(pv.sum())} points), "
              f"{int(qv.sum())} queries of frame 1, radius^2 {NN_GRID_RADIUS_SQ}: {ms:.1f} ms on "
              f"{kind} (host clock), equal to its CPU run; against K1: "
              f"{int(b['valid'].sum())} neighbours, {why['rows']} rows differ ({why['ties']} "
              f"ties, {why['duplicates']} with a colliding bucket's duplicate, "
              f"{why['overflow']} beside a bucket over {NN_GRID_PER_CELL} rows), d2 of the same "
              f"neighbours within {u.max(initial=0)} ulp")

    # (g) the profiler: the spans above, and one under torch.profiler
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as trace:
        with prof.scope("tools.mm_info (traced)"):
            printed(mm_info.main, [d / "frame0.mm.npz"])
    names = {e.name for e in trace.events()}
    check("tools.mm_info (traced)" in names, "the Profiler span is not among the trace's events")
    print("[tools] Profiler spans of the phase (host clock, no sync; the traced span found "
          "among torch.profiler's events):")
    for line in prof.report().splitlines():
        print(f"    | {line}")
    # the inputs and outputs go (made again from the seeds); the card's pages stay
    for f in sorted(d.iterdir()):
        if f.name not in ("map_card.html", "log_card.html"):
            f.unlink()
    kept = sorted(d.iterdir())
    print(f"[tools] kept under {d.relative_to(REPO)}: "
          f"{sum(f.stat().st_size for f in kept) / 2**20:.1f} MiB ({', '.join(f.name for f in kept)})")


def graph_inputs(n, multiple=1):
    """lap_graph(n) on the card: (gt, init poses, edges padded to a
    multiple of ``multiple``, the padded edges as numpy)."""
    from mp2p_icp_tpu_torch.convert import pose_graph_edges_from_numpy

    gt, init, e = lap_graph(n)
    e = pad_edges(e, multiple)
    p0 = se3.Pose(torch.from_numpy(init[:, :3, :3].astype(np.float32)).to(default_device()),
                  torch.from_numpy(init[:, :3, 3].astype(np.float32)).to(default_device()))
    return gt, p0, pose_graph_edges_from_numpy(**e), e


def timed_solve(solve):
    """(poses, chi², host seconds) of one synchronised solve."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt, chi2 = solve()
    chi2 = float(chi2)
    torch.cuda.synchronize()
    return opt, chi2, time.perf_counter() - t0


def pose_graph_phase(smi, kind):
    """Phase 14 (a): the pose graph at KITTI 00's length on the card, dense
    and CG, each twice (equal to the bit), held against each other and
    against the JAX CPU reference; the dense solve on the 1,000-node graph
    against JAX's. Returns the one-rank results the sharded solves are
    held to: {"dense": (poses, chi²) on the small graph, "cg": on the big
    graph with POSE_GRAPH_CG_SHARDED}."""
    from mp2p_icp_tpu_torch.parallel import pose_graph as pg

    ref = PARALLEL_JAX["pose_graph"]
    cg_params = pg.PoseGraphCGParams(**POSE_GRAPH_CG)
    dense_params = pg.PoseGraphParams()
    gt, p0, edges, e = graph_inputs(POSE_GRAPH_NODES, SHARDS)
    n_loop = int((np.asarray(e["valid"]) & (np.asarray(e["j"]) - np.asarray(e["i"]) > 1)).sum())
    chi0 = float(pg.chi2_of(p0, edges))
    print(f"[pose-graph] {POSE_GRAPH_NODES} nodes lapping a {POSE_GRAPH_LAPS}-lap circuit, "
          f"{POSE_GRAPH_NODES - 1} odometry and {n_loop} loop edges (+{len(e['i']) - n_loop - POSE_GRAPH_NODES + 1} invalid pad), "
          f"chi2 {chi0:.6g} before [JAX CPU reference: {ref['cg']['chi2_before']:.6g}]")
    out = {}
    for name, solve, iters in (
            ("dense", lambda: pg.optimize_pose_graph(p0, edges, dense_params),
             dense_params.max_iterations),
            ("cg", lambda: pg.optimize_pose_graph_cg(p0, edges, cg_params),
             cg_params.max_iterations)):
        runs = [timed_solve(solve) for _ in range(2)]
        (opt, chi2, sec), (opt2, chi2b, sec2) = runs
        same = torch.equal(opt.R, opt2.R) and torch.equal(opt.t, opt2.t) and chi2 == chi2b
        err = float(np.linalg.norm(opt.t.cpu().numpy() - gt[:, :3, 3], axis=1).mean())
        print(f"[pose-graph] {name} on {kind}: chi2 {chi0:.6g} -> {chi2:.8g}, mean error to the "
              f"truth {err:.4f} m, {sec2 * 1e3 / iters:.1f} ms per Gauss-Newton iteration "
              f"(warm; cold {sec * 1e3 / iters:.1f}; {iters} iterations"
              f"{f' of {cg_params.cg_iterations} CG steps' if name == 'cg' else ''}, the final "
              f"chi2 included); two runs equal to the bit: {same} on {smi}")
        check(same, f"pose graph {name}: two runs differ")
        check(np.isfinite(opt.t.cpu().numpy()).all() and chi2 < chi0, f"pose graph {name}: "
              f"chi2 {chi2} not below {chi0}")
        out[name] = (opt, chi2)
    rel = abs(out["cg"][1] - out["dense"][1]) / max(1.0, out["dense"][1])
    print(f"[pose-graph] CG against dense: chi2 relative gap {rel:.3g} (must be <= 1e-4, "
          f"tests/test_pose_graph.py:122), translations within "
          f"{float((out['cg'][0].t - out['dense'][0].t).abs().max()):.4g} m")
    check(rel <= 1e-4, f"pose graph: CG chi2 {out['cg'][1]} and dense {out['dense'][1]} differ")
    gap = float(np.abs(out["cg"][0].t.cpu().numpy() - np.asarray(ref["cg"]["t"])).max())
    rel_j = abs(out["cg"][1] - ref["cg"]["chi2"]) / ref["cg"]["chi2"]
    print(f"[pose-graph] CG against JAX's CG on the CPU (float32): translations within "
          f"{gap:.4g} m (band {PG_CG_BAND} m), chi2 {out['cg'][1]:.8g} against "
          f"{ref['cg']['chi2']:.8g} (relative {rel_j:.3g})")
    check(gap <= PG_CG_BAND, f"pose graph: CG {gap} m from JAX's")
    # the dense solve against JAX's on the 1,000-node graph
    _, p0s, edges_s, _ = graph_inputs(POSE_GRAPH_SMALL, SHARDS)
    opt_s, chi_s, sec_s = timed_solve(lambda: pg.optimize_pose_graph(p0s, edges_s, dense_params))
    gap_s = float(np.abs(opt_s.t.cpu().numpy() - np.asarray(ref["dense_small"]["t"])).max())
    print(f"[pose-graph] dense, {POSE_GRAPH_SMALL} nodes on {kind}: chi2 {chi_s:.8g} "
          f"[JAX CPU reference {ref['dense_small']['chi2']:.8g}], translations within "
          f"{gap_s:.4g} m of JAX's (band {PG_DENSE_BAND} m), "
          f"{sec_s * 1e3 / dense_params.max_iterations:.1f} ms per iteration")
    check(gap_s <= PG_DENSE_BAND, f"pose graph: dense {gap_s} m from JAX's")
    cg_sharded = pg.PoseGraphCGParams(**POSE_GRAPH_CG_SHARDED)
    opt_c, chi_c, sec_c = timed_solve(lambda: pg.optimize_pose_graph_cg(p0, edges, cg_sharded))
    print(f"[pose-graph] cg with {cg_sharded.cg_iterations} CG steps (the sharded run's "
          f"reference): chi2 {chi_c:.8g}, {sec_c * 1e3 / cg_sharded.max_iterations:.1f} ms per "
          f"Gauss-Newton iteration")
    return {"dense": (opt_s, chi_s, sec_s), "cg": (opt_c, chi_c, sec_c)}


def loop_closure_phase(smi, kind, launches, by_path):
    """Phase 14 (b): kitti-odometry --mapping --loop-closure on an
    out-and-back drive at HDL-64E geometry, held to the JAX CPU reference:
    the candidates, the accepted loops, the printed line, ATE before and
    after the closure, and the correction itself: JAX's odometry poses and
    loop measurements through the port's optimize_trajectory on the card,
    beside JAX's corrected poses."""
    from mp2p_icp_tpu_torch import loop_closure
    from mp2p_icp_tpu_torch.apps import kitti_odometry
    from mp2p_icp_tpu_torch.eval.trajectory import load_kitti_poses

    ref = PARALLEL_JAX["loop_closure"]
    t0 = time.perf_counter()
    bin_dir, gt_path, gt = write_loop_sequence(LOOP_DIR / "sequence", LOOP_FRAMES, APPS_RINGS,
                                               APPS_AZIMUTHS)
    config = LOOP_DIR / "cropped.yaml"
    config.write_text(ground_cropped_yaml())
    print(f"[loop] {LOOP_FRAMES} frames of the out-and-back drive ({APPS_RINGS} x "
          f"{APPS_AZIMUTHS} rays, out {gt[LOOP_FRAMES // 2, 0, 3]:.1f} m and back) written in "
          f"{time.perf_counter() - t0:.1f} s")
    # record the closure (its input poses, its result, its seconds) and the
    # iterations of its scan-to-scan aligns (the mapping run calls the
    # align loop directly, so every ICP.align here is the closure's)
    seen = {"iterations": 0}
    close, align = loop_closure.close_and_optimize, ICP.align

    def recorded_close(icp, params, clouds, poses, **kw):
        t1 = time.perf_counter()
        res = close(icp, params, clouds, poses, **kw)
        torch.cuda.synchronize()
        seen.update(poses=poses, result=res, seconds=time.perf_counter() - t1)
        return res

    def recorded_align(self, *a, **kw):
        res = align(self, *a, **kw)
        seen["iterations"] += res.n_iterations
        return res

    poses_path = LOOP_DIR / "poses.txt"
    loop_closure.close_and_optimize, ICP.align = recorded_close, recorded_align
    try:
        torch.cuda.synchronize()
        reset_counts()
        text, seconds = printed(kitti_odometry.main, [
            "--bin-dir", bin_dir, "-c", config, "--gt-poses", gt_path, "--mapping",
            "--map-capacity", APPS_MAP_CAPACITY, "--loop-closure", "--loop-min-gap", LOOP_MIN_GAP,
            "--loop-max-distance", LOOP_MAX_DISTANCE, "--out-poses", poses_path,
            "--device", default_device().type])
        n = counts()
    finally:
        loop_closure.close_and_optimize, ICP.align = close, align
    got = kitti_odometry_printed(text)
    calls = got["iterations"] + seen["iterations"]
    check(n["knn_bruteforce"] == calls and n["knn_streamed"] == n["knn_batched"] == 0,
          f"loop closure: launches {n}, matcher calls {got['iterations']} (mapping) + "
          f"{seen['iterations']} (closure)")
    launches["knn_bruteforce"] += n["knn_bruteforce"]
    by_path["knn_bruteforce"][f"kitti-odometry --mapping --loop-closure, {LOOP_FRAMES} frames"] = \
        n["knn_bruteforce"]
    count_own(launches, by_path, n,
             f"kitti-odometry --mapping --loop-closure, {LOOP_FRAMES} frames")
    poses = load_kitti_poses(str(poses_path))
    res = seen["result"]
    cands = loop_closure.propose_loop_candidates(seen["poses"], min_frame_gap=LOOP_MIN_GAP,
                                                 max_distance=LOOP_MAX_DISTANCE)
    before = trajectory_errors(seen["poses"], gt)
    after = trajectory_errors(poses, gt)
    line = next(ln for ln in text.splitlines() if ln.startswith("[loop-closure]"))
    print(f"[loop] kitti-odometry --mapping --loop-closure on {kind}: {line!r} [JAX CPU "
          f"reference: {ref['printed']}]; candidates {cands}; accepted (i, j, quality) "
          f"{[(i, j, round(q, 4)) for i, j, q in res['loops']]}; ATE {before[0]:.4f} m before "
          f"the closure, {after[0]:.4f} m after [JAX CPU reference: {ref['ate_before_m']:.4f} "
          f"-> {ref['ate_m']:.4f} m]; {1e3 / got['scans_per_s']:.1f} ms per frame (the app's "
          f"timer), the closure {seen['seconds']:.2f} s ({len(cands)} aligns, "
          f"{seen['iterations']} iterations, and the pose graph); {n['knn_bruteforce']} K1 launches "
          f"== {got['iterations']} + {seen['iterations']} matcher calls; {seconds:.1f} s for "
          f"the call on {smi}")
    # the same pairs; their order (closest first) follows distances of a
    # few cm between the two runs' odometry
    check(sorted(map(list, cands)) == sorted(ref["candidates"]),
          f"loop closure: candidates {cands}, JAX {ref['candidates']}")
    check(sorted([i, j] for i, j, _q in res["loops"]) == sorted([i, j] for i, j, _q in ref["loops"]),
          f"loop closure: accepted {res['loops']}, JAX {ref['loops']}")
    check([line] == ref["printed"], f"loop closure: printed {line!r}, JAX {ref['printed']}")
    # the closure must gain at least half of what JAX's gained: a pose graph
    # that returned the odometry unchanged gains nothing
    margin = 0.5 * (ref["ate_before_m"] - ref["ate_m"])
    check(after[0] <= max(1.5 * ref["ate_m"], ref["ate_m"] + 0.01)
          and after[0] <= before[0] - margin,
          f"loop closure: ATE {after[0]} m after (before {before[0]}, must gain {margin} m), "
          f"JAX {ref['ate_before_m']} -> {ref['ate_m']}")

    # the correction on JAX's own inputs: its odometry and loop measurements
    def poses_of(rows):
        out = np.tile(np.eye(4), (len(rows), 1, 1))
        out[:, :3, :] = np.asarray(rows, np.float64).reshape(-1, 3, 4)
        return out

    j_odo, j_fixed = poses_of(ref["poses_odometry"]), poses_of(ref["poses"])
    dev = default_device()
    j_loops = [(i, j, se3.Pose(torch.tensor(R, dtype=torch.float32, device=dev).reshape(3, 3),
                               torch.tensor(t_, dtype=torch.float32, device=dev)), q)
               for i, j, R, t_, q in ref["loop_measurements"]]
    fixed = loop_closure.optimize_trajectory(j_odo, j_loops)
    gap = float(np.linalg.norm(fixed[:, :3, 3] - j_fixed[:, :3, 3], axis=1).max())
    rot = float(np.abs(fixed[:, :3, :3] - j_fixed[:, :3, :3]).max())
    moved = float(np.linalg.norm(j_fixed[:, :3, 3] - j_odo[:, :3, 3], axis=1).max())
    print(f"[loop] optimize_trajectory on the card from JAX's odometry poses and its "
          f"{len(j_loops)} loop measurements: every corrected pose within {gap:.3g} m and "
          f"{rot:.3g} (rotation entries) of JAX's (band {PG_DENSE_BAND} m); JAX's correction "
          f"moves a pose up to {moved:.3f} m")
    check(gap <= PG_DENSE_BAND and rot <= PG_DENSE_BAND,
          f"loop closure: the correction of JAX's inputs is {gap} m, {rot} from JAX's")
    shutil.rmtree(LOOP_DIR / "sequence")  # 100 MB of scans: chiprun_out/ stays small


SHARDS = 4  # the sharded kNN's, the spatial aligns' and the sharded pose graph's ranks
RANK_DEVICE = "cuda:0"  # every rank on the one card
# m: the card's pose graph against JAX's float32 one on the CPU (the align
# band; the port on the CPU: CG within 5.1e-4 m, dense 1.1e-3 m)
PG_CG_BAND = PG_DENSE_BAND = 5e-3


def layer_numpy_dict(layers):
    """{name: {field: numpy array}} of a layer dict (the form the ranks take)."""
    from mp2p_icp_tpu_torch.convert import pointcloud_to_numpy

    return {k: pointcloud_to_numpy(v) for k, v in layers.items()}


def np_pose(p):
    return p.R.cpu().numpy(), p.t.cpu().numpy()


def parallel_phase(smi, kind, launches, by_path, one_rank, knn_case, align_cases,
                   batch_case, odometry_case):
    """Phase 14 (c): the sharded paths, several ranks on the one card over
    gloo (NCCL refuses two ranks on one GPU): 4 ranks for the sharded kNN,
    the spatial aligns and the sharded pose graph; 2 ranks, started by
    init_from_env from the MP2P_* variables, for SpatialOdometryMapper and
    the data-parallel batch. Each rank's launches and ms beside the one
    process path's."""
    from mp2p_icp_tpu_torch.odometry import voxel_owner
    from mp2p_icp_tpu_torch.parallel import pose_graph as pg
    from mp2p_icp_tpu_torch.parallel import ranks
    from mp2p_icp_tpu_torch.parallel.launch import spawn_ranks

    q, points, ks = knn_case
    _, p0_small, _, e_small = graph_inputs(POSE_GRAPH_SMALL, SHARDS)
    _, p0_big, _, e_big = graph_inputs(POSE_GRAPH_NODES, SHARDS)
    tasks = [(ranks.sharded_knn, (q, points, ks, 5))]
    for label, (icp, params, scan, gmap, guess, _ref, _ms) in align_cases.items():
        tasks.append((ranks.spatial_align, (icp, params, layer_numpy_dict(scan),
                                            layer_numpy_dict(gmap), np_pose(guess), 2)))
    tasks += [(ranks.pose_graph, (np_pose(p0_small), e_small, "dense", pg.PoseGraphParams())),
              (ranks.pose_graph, (np_pose(p0_big), e_big, "cg",
                                  pg.PoseGraphCGParams(**POSE_GRAPH_CG_SHARDED)))]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out4 = spawn_ranks(ranks.sequence, SHARDS, "gloo", args=(tasks,), device=RANK_DEVICE)
    print(f"[parallel] {SHARDS} ranks on the one card (gloo; CUDA tensors through the host) "
          f"ran {len(tasks)} paths in {time.perf_counter() - t0:.1f} s, start-up included; "
          f"seconds per path on rank 0: {[round(r['seconds'], 1) for r in out4[0]]}")
    per_task = list(zip(*out4))

    # the sharded kNN against one sweep of the whole map
    knn = per_task[0]
    dev = default_device()
    qd = torch.from_numpy(q).to(dev)
    pd = torch.from_numpy(points).to(dev)
    ones = torch.ones
    for k in ks:
        reset_counts()
        whole = nnb.knn_bruteforce(qd, ones(len(q), dtype=torch.bool, device=dev), pd,
                                   ones(len(points), dtype=torch.bool, device=dev), k=k)
        torch.cuda.synchronize()
        kernel = "knn_streamed" if len(points) > nnb.STREAM_BLOCK else "knn_bruteforce"
        check(counts()[kernel] == 1, "the one sweep of the whole map: not one launch")
        one_ms = cuda_ms(lambda: nnb.knn_bruteforce(
            qd, ones(len(q), dtype=torch.bool, device=dev), pd,
            ones(len(points), dtype=torch.bool, device=dev), k=k), reps=5)
        same = all(np.array_equal(r[k]["idx"], whole.idx.cpu().numpy())
                   and np.array_equal(r[k]["dist_sq"], whole.dist_sq.cpu().numpy()) for r in knn)
        shard_kernel = ("knn_streamed" if knn[0]["shard_rows"] > nnb.STREAM_BLOCK
                        else "knn_bruteforce")
        per_rank = [r[k]["launches"] for r in knn]
        print(f"[parallel] sharded kNN, {len(q)} scan points against the {len(points)}-point "
              f"corridor map in {SHARDS} shards of {knn[0]['shard_rows']} rows, k={k}: d2 and "
              f"global idx equal to one sweep of the whole map on every rank: {same}; launches "
              f"per rank {[n[shard_kernel] for n in per_rank]} of {shard_kernel}; "
              f"{knn[0][k]['ms']:.3f} ms per sharded call (4 sweeps at once, the all_gather and "
              f"the merge) against {one_ms:.3f} ms for the one sweep of the whole map on {smi}")
        check(same, f"sharded kNN k={k}: not equal to one sweep of the whole map")
        check(all(n[shard_kernel] == 1 and knn_launches(n) == 1 for n in per_rank),
              f"sharded kNN k={k}: launches {per_rank}")
        launches[shard_kernel] += sum(n[shard_kernel] for n in per_rank)
        by_path[shard_kernel][f"sharded kNN k={k}, {SHARDS} ranks"] = \
            [n[shard_kernel] for n in per_rank]

    # the spatial aligns against the one-process aligns
    for a, (label, (icp, params, scan, gmap, guess, ref, one_ms)) in enumerate(
            align_cases.items()):
        got = per_task[1 + a]
        name = next(iter(gmap))
        crop = params.crop_capacity
        whole_box = int(icp.in_crop_box(params, gmap[name], scan, guess).sum())
        boxes = [r["in_box"][name] for r in got]
        overflow = whole_box > crop or any(b > crop for b in boxes)
        kernel = "knn_streamed" if crop > nnb.STREAM_BLOCK else "knn_bruteforce"
        calls = matcher_calls(icp, got[0]["iterations"])
        per_rank = [r["launches"] for r in got]
        t_gap = max(float(np.abs(r["pose"][1] - ref.optimal_tf.t.cpu().numpy()).max())
                    for r in got)
        R_gap = max(float(np.abs(r["pose"][0] - ref.optimal_tf.R.cpu().numpy()).max())
                    for r in got)
        same_its = all(r["iterations"] == ref.n_iterations
                       and r["termination"] == ref.termination_reason.name for r in got)
        print(f"[parallel] make_spatial_align, scan to the {label} map in {SHARDS} shards of "
              f"{gmap[name].capacity // SHARDS} rows, each cropped to {crop} (if larger): in-box rows per "
              f"shard {boxes} (whole map {whole_box}; a crop overflows: {overflow}); "
              f"{got[0]['iterations']} iterations, {got[0]['termination']} [one process: "
              f"{ref.n_iterations}, {ref.termination_reason.name}]; pose gap to the one-process "
              f"align R {R_gap:.3g}, t {t_gap:.3g}; launches per rank "
              f"{[n[kernel] for n in per_rank]} of {kernel} == {calls} matcher calls; "
              f"{got[0]['ms']:.1f} ms per align against {one_ms:.1f} ms in one process on {smi}")
        if overflow:
            check(t_gap <= 5e-3 and abs(got[0]["iterations"] - ref.n_iterations) <= 1,
                  f"spatial align {label}: {t_gap} m, iterations {got[0]['iterations']}")
        else:
            check(t_gap == 0.0 and R_gap == 0.0 and same_its,
                  f"spatial align {label}: not the one-process align to the bit")
        check(all(n[kernel] == calls and knn_launches(n) == calls for n in per_rank),
              f"spatial align {label}: launches {per_rank}, matcher calls {calls}")
        launches[kernel] += sum(n[kernel] for n in per_rank)
        by_path[kernel][f"spatial align, {label} map, {SHARDS} ranks"] = \
            [n[kernel] for n in per_rank]
        count_own(launches, by_path, per_rank, f"spatial align, {label} map, {SHARDS} ranks")

    # the sharded pose graph against one rank
    for t_i, which in ((1 + len(align_cases), "dense"), (2 + len(align_cases), "cg")):
        got = per_task[t_i]
        opt, chi2, sec = one_rank[which]
        gap = max(float(np.abs(r["pose"][1] - opt.t.cpu().numpy()).max()) for r in got)
        alike = all(np.array_equal(r["pose"][1], got[0]["pose"][1]) for r in got)
        nodes = POSE_GRAPH_SMALL if which == "dense" else POSE_GRAPH_NODES
        steps = (f", {POSE_GRAPH_CG_SHARDED['cg_iterations']} CG steps" if which == "cg" else "")
        print(f"[parallel] pose graph {which} ({nodes} nodes{steps}) with the edges over "
              f"{SHARDS} ranks: within {gap:.3g} m of one rank (band 1e-3 m), chi2 "
              f"{got[0]['chi2']:.8g} [one rank {chi2:.8g}], every rank the same bits: {alike}; "
              f"{got[0]['solve_ms'] / 10:.1f} ms per Gauss-Newton iteration against "
              f"{sec * 1e2:.1f} on one rank on {smi}")
        check(gap <= 1e-3 and alike, f"sharded pose graph {which}: {gap} m from one rank")

    # the 2-rank paths: SpatialOdometryMapper and the data-parallel batch
    mapper, frames_np, twists, gt, run_1 = odometry_case
    icp_b, params_b, locals_np, map_np, guesses, rb, b_ms = batch_case
    t0 = time.perf_counter()
    out2 = spawn_ranks(ranks.sequence, SPATIAL_RANKS, "gloo", device=RANK_DEVICE, init="env", args=([
        (ranks.spatial_mapper, (mapper, frames_np, twists, (gt[0, :3, :3], gt[0, :3, 3]),
                                ODO_DT, ODO_RESOLUTION)),
        (ranks.data_parallel_batch, (icp_b, params_b, locals_np, map_np, guesses, 2))],))
    print(f"[parallel] {SPATIAL_RANKS} ranks on the one card, started by init_from_env from "
          f"MP2P_COORDINATOR / MP2P_NUM_PROCESSES / MP2P_PROCESS_ID (gloo): 2 paths in "
          f"{time.perf_counter() - t0:.1f} s, start-up included; seconds per path on rank 0: "
          f"{[round(r['seconds'], 1) for r in out2[0]]}")
    sm, db = [r[0] for r in out2], [r[1] for r in out2]
    ref = PARALLEL_JAX["spatial_mapper"]
    ate = ate_rmse(sm[0]["poses"], gt)
    m = sm[0]["map"]
    sets = []
    for s in range(SPATIAL_RANKS):
        xyz = m["xyz"][s][: m["count"][s]]
        owner = voxel_owner(torch.from_numpy(xyz), ODO_RESOLUTION, SPATIAL_RANKS).numpy()
        check(len(xyz) > 0 and (owner == s).all(), f"spatial mapper: shard {s} owns a foreign voxel")
        sets.append({tuple(c) for c in np.floor(xyz / ODO_RESOLUTION).astype(np.int64)})
    shared = len(sets[0] & sets[1])
    n1 = int(run_1["map"].count)
    one = {tuple(c) for c in np.floor(run_1["map"].xyz[:n1].cpu().numpy()
                                      / ODO_RESOLUTION).astype(np.int64)}
    union = set().union(*sets)
    jac = len(one & union) / len(one | union)
    per_rank = [r["launches"] for r in sm]
    calls = (sum(matcher_calls(mapper.icp, int(i)) for i in sm[0]["iterations"])
             + (len(frames_np) - 1) + 1)
    frame_ms = np.median(sm[0]["frame_seconds"]) * 1e3
    print(f"[parallel] SpatialOdometryMapper, the {len(frames_np)}-frame drive over "
          f"{SPATIAL_RANKS} ranks (incremental map, 2 shards of {m['xyz'].shape[1]} rows): ATE "
          f"{ate:.4f} m [JAX CPU reference over 2 devices: {ref['ate_m']:.4f} m; one process "
          f"on the card: {ate_rmse(run_1['poses'], gt):.4f} m]; shard maps {m['count'].tolist()} "
          f"points [JAX: {ref['map_points']}], voxels on two shards: {shared}; the union's "
          f"voxels {len(union)} against the one-process map's {len(one)}: Jaccard {jac:.4f}; "
          f"every rank the same poses: {np.array_equal(sm[0]['poses'], sm[1]['poses'])}; "
          f"dropped {[r['dropped'] for r in sm]}; K1 launches per rank "
          f"{[n['knn_bruteforce'] for n in per_rank]} == {calls} (matcher calls + normals fits + "
          f"the seed's); {frame_ms:.1f} ms per frame (median) against "
          f"{np.median(run_1['frame_seconds']) * 1e3:.1f} in one process on {smi}")
    check(shared == 0 and jac >= 0.97 and all(r["dropped"] == 0 for r in sm),
          f"spatial mapper: {shared} voxels on two shards, Jaccard {jac}")
    check(np.array_equal(sm[0]["poses"], sm[1]["poses"]), "spatial mapper: the ranks' poses differ")
    check(ate <= max(1.5 * ref["ate_m"], ref["ate_m"] + 0.01),
          f"spatial mapper: ATE {ate} m outside max(1.5x, +0.01 m) of JAX's {ref['ate_m']}")
    check(all(n["knn_bruteforce"] == calls and knn_launches(n) == calls for n in per_rank),
          f"spatial mapper: launches {per_rank}, expected {calls} K1")
    launches["knn_bruteforce"] += sum(n["knn_bruteforce"] for n in per_rank)
    by_path["knn_bruteforce"][f"SpatialOdometryMapper, {len(frames_np)} frames, "
                         f"{SPATIAL_RANKS} ranks"] = [n["knn_bruteforce"] for n in per_rank]
    count_own(launches, by_path, per_rank,
             f"SpatialOdometryMapper, {len(frames_np)} frames, {SPATIAL_RANKS} ranks")

    per_rank = [r["launches"] for r in db]
    R, t = rb.optimal_tf.R.cpu().numpy(), rb.optimal_tf.t.cpu().numpy()
    same = all(np.array_equal(r["R"], R) and np.array_equal(r["t"], t)
               and np.array_equal(r["iterations"], rb.n_iterations.cpu().numpy()) for r in db)
    print(f"[parallel] data-parallel batch: {len(guesses)} scans against the shared 1M map, "
          f"{db[0]['rows']} per rank over {SPATIAL_RANKS} ranks: every rank's fetched poses "
          f"and iterations equal to the one-process batch to the bit: {same}; K2 launches per "
          f"rank {[n['knn_batched'] for n in per_rank]}; {db[0]['ms']:.1f} ms per call "
          f"against {b_ms:.1f} ms for all {len(guesses)} in one process on {smi}")
    check(same, "data-parallel batch: not the one-process batch")
    its = rb.n_iterations.cpu().numpy()
    rows = len(guesses) // SPATIAL_RANKS
    for r_, n in enumerate(per_rank):
        calls = matcher_calls(icp_b, int(its[r_ * rows:(r_ + 1) * rows].max()))
        check(n["knn_batched"] == calls and knn_launches(n) == calls,
              f"data-parallel batch rank {r_}: launches {n}, matcher calls {calls}")
    launches["knn_batched"] += sum(n["knn_batched"] for n in per_rank)
    by_path["knn_batched"][f"data-parallel batch, {SPATIAL_RANKS} ranks"] = \
        [n["knn_batched"] for n in per_rank]
    count_own(launches, by_path, per_rank, f"data-parallel batch, {SPATIAL_RANKS} ranks")


MESH_RANKS, MESH_SPACE = 4, 2  # the data x space phase's 2 x 2 mesh
DRYRUN_TIMEOUT = 600  # s: the phase's spawn, and scripts/torch_multichip_dryrun.py 4


def mesh_phase(smi, kind, launches, by_path, errs, shapes, micp, bparams, problems, map_1m,
               rb, b_ms):
    """Phase 15: the batched align over a data x space mesh of 4 ranks on
    the one card (gloo), at full width (phase 6's batch against the shared
    1M map) and on the JAX dry run's problems; K2 at a rank's shape; the
    dry run itself as a subprocess."""
    import torch.utils._pytree as pytree

    from mp2p_icp_tpu_torch.core.pointcloud import round_capacity
    from mp2p_icp_tpu_torch.parallel import ranks
    from mp2p_icp_tpu_torch.parallel.batch import crop_batched
    from mp2p_icp_tpu_torch.parallel.launch import spawn_ranks
    from mp2p_icp_tpu_torch.parallel.mesh import MeshAxis
    from mp2p_icp_tpu_torch.parallel.spatial import own_shard

    sys.path.insert(0, str(REPO / "scripts"))
    import torch_multichip_dryrun as dryrun

    # (a) the crop capacities: the one-process reference keeps every in-box
    # row of the whole map, the mesh every in-box row of each shard; each
    # shard's rows keep their order, so the two sweeps meet the same rows
    gmap = map_1m["map"]
    in_box = [int(micp.in_crop_box(bparams, gmap, scan, guess).sum())
              for scan, guess, _ in problems]
    shards = [own_shard(map_1m, MeshAxis("space", MESH_SPACE, s))["map"]
              for s in range(MESH_SPACE)]
    shard_box = [[int(micp.in_crop_box(bparams, sh, scan, guess).sum()) for sh in shards]
                 for scan, guess, _ in problems]
    del shards
    ref_crop = max(bparams.crop_capacity, round_capacity(max(in_box)))
    crop = max(bparams.crop_capacity, round_capacity(max(map(max, shard_box))))
    shard_rows = -(-gmap.capacity // MESH_SPACE)
    params = dataclasses.replace(bparams, crop_capacity=crop)
    l_b = stack_pytrees([pr_[0] for pr_ in problems])
    g_b = stack_pytrees([pr_[1] for pr_ in problems])
    if ref_crop == bparams.crop_capacity:
        ref, ref_ms, what = rb, b_ms, "phase 6's batch"
    else:  # phase 6's crop strides: its batch at the wider crop is the reference
        fn = make_batched_align(micp, dataclasses.replace(bparams, crop_capacity=ref_crop),
                                broadcast_globals=True)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = fn(l_b, map_1m, g_b)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        ref_ms, what = statistics.median(walls[1:]) * 1e3, f"phase 6's batch at crop {ref_crop}"
    kept = "keeps them all" if ref_crop == bparams.crop_capacity else "strides"
    cropped = (f"each {shard_rows}-row shard is cropped" if shard_rows > crop
               else f"the {shard_rows}-row shards are not cropped")
    print(f"[mesh] in-box rows per scan of the whole 1M map {in_box} and of its "
          f"{MESH_SPACE} shards {shard_box}: phase 6's crop {bparams.crop_capacity} {kept}; "
          f"the reference's crop {ref_crop}, the mesh's {crop} >= every shard's count, so no "
          f"shard's crop overflows ({cropped})")
    check(max(in_box) <= ref_crop and max(map(max, shard_box)) <= crop,
          f"mesh: a crop overflows ({in_box} / {ref_crop}, {shard_box} / {crop})")

    # (b) the dry run's problems, B = 2 x n_data
    d_globs, d_locals, d_guesses = dryrun.batch_problems(MESH_RANKS // MESH_SPACE)
    d_icp, d_params = dryrun.make_icp(), ICPParameters(max_iterations=5)
    d_ref = dryrun.one_process_batch(d_icp, d_params, d_globs, d_locals, d_guesses,
                                     default_device())

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    guesses = [np_pose(pr_[1]) for pr_ in problems]
    t0 = time.perf_counter()
    out = spawn_ranks(ranks.sequence, MESH_RANKS, "gloo", device=RANK_DEVICE, init="env",
                      timeout=DRYRUN_TIMEOUT, args=([
        (ranks.data_parallel_batch, (micp, params, [layer_numpy_dict(pr_[0]) for pr_ in problems],
                                     layer_numpy_dict(map_1m), guesses, 2, MESH_SPACE)),
        (ranks.data_parallel_batch, (d_icp, d_params, d_locals, d_globs, d_guesses, 0,
                                     MESH_SPACE))],))
    print(f"[mesh] {MESH_RANKS} ranks on the one card as a {MESH_RANKS // MESH_SPACE} x "
          f"{MESH_SPACE} (data x space) mesh, started by init_from_env (gloo; CUDA tensors "
          f"through the host): 2 paths in {time.perf_counter() - t0:.1f} s, start-up included; "
          f"seconds per path on rank 0: {[round(r['seconds'], 1) for r in out[0]]}")
    full, tiny = [r[0] for r in out], [r[1] for r in out]

    R, t = ref.optimal_tf.R.cpu().numpy(), ref.optimal_tf.t.cpu().numpy()
    its, term = ref.n_iterations.cpu().numpy(), ref.termination_reason.cpu().numpy()
    same = all(np.array_equal(r["R"], R) and np.array_equal(r["t"], t)
               and np.array_equal(r["iterations"], its) and np.array_equal(r["termination"], term)
               for r in full)
    gap = max(max(float(np.abs(r["R"] - R).max()), float(np.abs(r["t"] - t).max())) for r in full)
    rows = full[0]["rows"]
    per_rank = [r["launches"] for r in full]
    calls = [matcher_calls(micp, int(its[(i // MESH_SPACE) * rows:
                                         (i // MESH_SPACE + 1) * rows].max()))
             for i in range(MESH_RANKS)]
    print(f"[mesh] {len(problems)} scans of {N_POINTS} points against the shared 1M map, "
          f"{rows} per data rank, a {shard_rows}-row shard per space rank: R, t, iterations "
          f"{full[0]['iterations'].tolist()} and terminations "
          f"{[IterTermReason(int(x)).name for x in full[0]['termination']]} on every rank "
          f"equal to {what} to the bit: {same} (max |R, t difference| {gap:.3g}); in-box rows "
          f"of each rank's shard per scan {[r['in_box']['map'] for r in full]}")
    print(f"[mesh] K2 launches per rank {[n['knn_batched'] for n in per_rank]} == matcher "
          f"calls {calls}, K1 / K3 {[n['knn_bruteforce'] + n['knn_streamed'] for n in per_rank]}; "
          f"all_gathers over space per rank {[r['gathers'] for r in full]} (one per matcher call "
          f"for the rank's {rows} scans); {full[0]['ms']:.1f} ms per call on the mesh against "
          f"{ref_ms:.1f} ms for all {len(problems)} in one process on {smi}")
    check(same, "mesh: the batch on the 2 x 2 mesh is not the one-process batch")
    check(all(n <= crop for r in full for n in r["in_box"]["map"]),
          f"mesh: a rank's shard holds more in-box rows than its crop of {crop} keeps")
    for i, n in enumerate(per_rank):
        check(n["knn_batched"] == calls[i] and knn_launches(n) == calls[i]
              and full[i]["gathers"] == calls[i],
              f"mesh rank {i}: launches {n}, gathers {full[i]['gathers']}, calls {calls[i]}")
    launches["knn_batched"] += sum(n["knn_batched"] for n in per_rank)
    by_path["knn_batched"][f"data x space batch, 8 x 1M map, {MESH_RANKS} ranks"] = \
        [n["knn_batched"] for n in per_rank]
    count_own(launches, by_path, per_rank, f"data x space batch, 8 x 1M map, {MESH_RANKS} ranks")

    want = PARALLEL_JAX["data_space"]
    n_b = len(d_guesses)
    jt, jR = np.asarray(want["t"])[:n_b], np.asarray(want["R"])[:n_b]
    d_same = all(np.array_equal(r["R"], d_ref[0]) and np.array_equal(r["t"], d_ref[1])
                 and np.array_equal(r["iterations"], d_ref[2])
                 and np.array_equal(r["termination"], d_ref[3]) for r in tiny)
    d_errs = np.linalg.norm(tiny[0]["t"] - np.asarray(dryrun.GT[:3], np.float32), axis=-1)
    j_gap = max(float(np.abs(tiny[0]["t"] - jt).max()), float(np.abs(tiny[0]["R"] - jR).max()))
    j_its = np.abs(tiny[0]["iterations"] - np.asarray(want["iterations"])[:n_b]).max()
    j_term = np.array_equal(tiny[0]["termination"], np.asarray(want["termination"])[:n_b])
    print(f"[mesh] the JAX dry run's problems, B={n_b} of {d_params.max_iterations} iterations "
          f"on the mesh: translation errors {d_errs.tolist()}, iterations "
          f"{tiny[0]['iterations'].tolist()}; equal to one process to the bit: {d_same}; against "
          f"the JAX package on a {want['mesh']['data']} x {want['mesh']['space']} mesh of CPU "
          f"devices: pose gap {j_gap:.3g}, iterations +-{j_its}, same terminations: {j_term}")
    check(d_same and (d_errs < 1e-3).all(), "mesh: the dry run's batch")
    check(j_gap < 5e-3 and j_its <= 1 and j_term, "mesh: outside the align band of JAX's")
    per_rank = [r["launches"] for r in tiny]
    launches["knn_batched"] += sum(n["knn_batched"] for n in per_rank)
    by_path["knn_batched"][f"data x space batch, the dry run's problems, "
                                 f"{MESH_RANKS} ranks"] = [n["knn_batched"] for n in per_rank]
    count_own(launches, by_path, per_rank,
             f"data x space batch, the dry run's problems, {MESH_RANKS} ranks")

    # (c) K2 at the shape rank 0 launches on its first iteration: its 4 scans
    # at their guesses against its shard, cropped at each guess
    shard = own_shard(map_1m, MeshAxis("space", MESH_SPACE, 0))
    l4, g4 = (pytree.tree_map(lambda x: x[:rows], tree) for tree in (l_b, g_b))
    g_c, _, g_dim = crop_batched(micp, params, shard, l4, g4, None)
    pc = g_c["map"]
    p = torch.where(pc.valid_mask()[..., None], pc.xyz, -1.0e8).contiguous()
    q = torch.stack([torch.where(l4["raw"].valid_mask()[b][:, None],
                                 se3.apply(se3.Pose(g4.R[b], g4.t[b]), l4["raw"].xyz[b]), 1.0e8)
                     for b in range(rows)]).contiguous()
    C = p.shape[-2]
    label = (f"K2 {rows}x{q.shape[1]}x{C} k=1 (a mesh rank's sweep"
             f"{', its cropped shards' if g_dim == 0 else ', its shard shared by the rows'})")
    errs["knn_batched"].append(compare(label, nnb.knn_sweep_batched,
                                             nnb.knn_plain_batched, q, p, 1))
    # as the rank's matcher calls it: with the counts of the front end
    n = (nnb.valid_count(l4["raw"].valid_mask()), nnb.valid_count(pc.valid_mask()))
    launch_line(rows, q.shape[1], C, 1, n)
    errs["knn_batched"].append(compare(label + " counted", nnb.knn_sweep_batched,
                                             nnb.knn_plain_batched, q, p, 1, *n))
    shapes["knn_batched"].append(kernel_row(
        "knn_batched", "a data x space rank's sweep", rows, q.shape[1], C, 1,
        lambda: nnb.knn_sweep_batched(q, p, 1, *n),
        lambda: nnb.knn_plain_batched(q, p, 1, *n),
        q, p, graph_ms(lambda: nnb.knn_sweep_batched(q, p, 1, *n)), smi, plain_reps=1,
        counts=n))
    del q, p, g_c, shard
    torch.cuda.empty_cache()

    # (d) the dry run, as a user runs it
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, str(REPO / "scripts" / "torch_multichip_dryrun.py"),
                          str(MESH_RANKS)], capture_output=True, text=True,
                         timeout=DRYRUN_TIMEOUT, cwd=REPO)
    for line in run.stdout.strip().splitlines()[-8:]:
        print(f"[dryrun] {line.removeprefix('[dryrun] ')}")
    print(f"[mesh] scripts/torch_multichip_dryrun.py {MESH_RANKS}: exit {run.returncode} in "
          f"{time.perf_counter() - t0:.1f} s")
    check(run.returncode == 0, f"the dry run failed: {run.stderr[-2000:]}")


BENCH_TIMEOUT = 600  # s: bench_torch.py at full size, a subprocess
# the keys of bench.py's line (its last record's ``parsed.extra``; only the
# names are read) and the two the port's line adds
BENCH_KEYS_FROM = REPO / "BENCH_r05.json"
BENCH_ADDED_KEYS = ("device", "power_limit_w")
BENCH_JAX_ITERS = 12  # the JAX package's iterations for the bench pair on the CPU


def bench_phase(smi, launches, by_path):
    """bench_torch.py at full size in a process of its own: its exit code,
    its one stdout line, every key of bench.py's line, errors < ERR_LIMIT,
    the bench pair's iterations and the odometry run against the JAX CPU
    reference; its kernels' launches (its own count, printed on stderr)
    added to the paths'. Its stderr goes to chiprun_out/bench_torch.log."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(REPO / "bench_torch.py")], cwd=REPO,
                         capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    secs = time.perf_counter() - t0
    logs = REPO / "chiprun_out"
    logs.mkdir(exist_ok=True)
    (logs / "bench_torch.log").write_text(out.stderr)
    notes = [ln for ln in out.stderr.splitlines() if " rep " not in ln]
    print("\n".join(f"[bench] | {ln}" for ln in notes[-30:]))
    check(out.returncode == 0, f"bench_torch.py exited {out.returncode}")
    lines = out.stdout.strip().splitlines()
    check(len(lines) == 1, f"bench_torch.py printed {len(lines)} lines on stdout, not 1")
    line = json.loads(lines[0])
    print(f"[bench] bench_torch.py in {secs:.1f} s: {lines[0]}")
    extra = line["extra"]
    want = set(json.loads(BENCH_KEYS_FROM.read_text())["parsed"]["extra"]) | set(BENCH_ADDED_KEYS)
    check(not want - set(extra), f"bench_torch.py: keys missing: {sorted(want - set(extra))}")
    check(set(line) == {"metric", "value", "unit", "vs_baseline", "extra"},
          f"bench_torch.py: the line's keys {sorted(line)}")
    check(extra["backend"] == "cuda", f"bench_torch.py: backend {extra['backend']}")
    errs = {k: v for k, v in extra.items() if k.endswith("_err") or k == "pose_err_se3_log"}
    check(all(0.0 <= v < ERR_LIMIT for v in errs.values()), f"bench_torch.py: errors {errs}")
    check(abs(extra["iters"] - BENCH_JAX_ITERS) <= 1,
          f"bench_torch.py: {extra['iters']} iterations, JAX's {BENCH_JAX_ITERS}")
    ate, ate_jax = extra["odometry_ate_m"], ODO_JAX["ate_m"]
    check(ate <= max(1.5 * ate_jax, ate_jax + 0.01),
          f"bench_torch.py: odometry ATE {ate} m outside max(1.5 x, + 0.01 m) of {ate_jax}")
    n_map = extra["odometry_map_points"]
    check(abs(n_map - ODO_JAX["map_points"]) <= 0.02 * ODO_JAX["map_points"],
          f"bench_torch.py: {n_map} map points, not within 2% of {ODO_JAX['map_points']}")
    counted = [ln for ln in out.stderr.splitlines() if ln.startswith("[bench] launches ")]
    check(len(counted) == 1, "bench_torch.py printed no launch count")
    n = json.loads(counted[0].removeprefix("[bench] launches "))
    check(all(n[name] > 0 for name in cuda_build.LIBRARIES),
          f"bench_torch.py: a kernel never ran: {n}")
    for name in cuda_build.LIBRARIES:
        launches[name] += n[name]
        by_path[name]["bench_torch.py (its own process)"] = n[name]
    print(f"[bench] ok: {len(want)} keys, errors {errs} < {ERR_LIMIT}, {extra['iters']} "
          f"iterations (JAX {BENCH_JAX_ITERS}), odometry ATE {ate} m (JAX {ate_jax}), "
          f"{n_map} map points (JAX {ODO_JAX['map_points']}); launches {n}; "
          f"{extra['device']}, {extra['power_limit_w']} W; nvidia-smi here: {smi}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile each path (phase 17)")
    args = ap.parse_args()

    clock = [time.perf_counter()]

    def phase_done(name):
        """Prints the host seconds since the previous phase ended."""
        clock.append(time.perf_counter())
        print(f"[phase] {name}: {clock[-1] - clock[-2]:.1f} s")

    # ---- 1. the card
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using {kind}")

    # ---- 2. build: one nvcc per kernel library, all started together
    t0 = time.perf_counter()
    cuda_build.build()
    for name in cuda_build.LIBRARIES:
        cuda_build.load_library(name)
        rec = cuda_build.build_record(name)
        print(f"[build] {source(name)} -> {rec['path']} for sm_90a: "
              f"{'compiled' if rec['built'] else 'cached'} in {rec['seconds']:.1f} s")
        entry = None
        for line in rec["log"].splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif ("registers" in line or "spill" in line) and entry and (
                    "ILi1E" in entry or "ILi8E" in entry):  # the k = 1 and k = 8 kernels
                print(f"[build]   {entry}: {line.strip().removeprefix('ptxas info    : ')}")
    print(f"[build] all kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    # the street drive of the odometry and fleet paths (its scans also give
    # the fleet shapes of phase 3 their data)
    t0 = time.perf_counter()
    gt_o, twists_o, scans_o = make_street_sequence(ODO_FRAMES, dt=ODO_DT)
    print(f"[odometry] {ODO_FRAMES} frames of 48 rings x 768 azimuths rendered in "
          f"{time.perf_counter() - t0:.1f} s")

    phase_done("build and street drive")
    # ---- 3. kernels against their plain versions
    errs = {name: [] for name in cuda_build.LIBRARIES}
    scene = make_scene(np.random.RandomState(0))
    loc, glob = street_pair(scene, 1, 2)
    made = [loc["raw"].xyz, loc["raw"].count, se3.identity().t, se3.from_xyz_ypr(*GT).R,
            Pairings.empty(pt2pt_cap=4).pt2pt.weight]
    check(all(t.device.type == "cuda" for t in made),
          f"a constructor without device= left the card: {[str(t.device) for t in made]}")
    print(f"[device] default_device() = {default_device()}; PointCloud.from_numpy, "
          f"se3.identity, se3.from_xyz_ypr and Pairings.empty without device= gave "
          f"{sorted({str(t.device) for t in made})}")
    q = loc["raw"].xyz.contiguous()
    p = glob["raw"].xyz.contiguous()
    for k in (1, 8):
        errs["knn_bruteforce"].append(compare(f"K1 {N_POINTS}x{N_POINTS} k={k}",
                                         nnb.knn_sweep, nnb.knn_plain, q, p, k))

    rng = np.random.RandomState(7)
    qr = torch.from_numpy(rng.uniform(-60, 60, (777, 3)).astype(np.float32))
    pr = torch.from_numpy(rng.uniform(-60, 60, (3001, 3)).astype(np.float32))
    qv = torch.from_numpy(rng.rand(777) > 0.1)
    pv = torch.from_numpy(rng.rand(3001) > 0.1)
    rad = torch.from_numpy(rng.uniform(1.0, 400.0, 777).astype(np.float32))
    qs = torch.where(qv[:, None], qr, 1.0e8).to(dev)  # the front end's sentinels
    ps = torch.where(pv[:, None], pr, -1.0e8).to(dev)
    for k in (4, 5):  # Point2Line's default and the 2D demo's k
        errs["knn_bruteforce"].append(compare(f"K1 777x3001 k={k} invalid rows",
                                         nnb.knn_sweep, nnb.knn_plain, qs, ps, k))
    # the 2D demo's sweeps: one planar scan against the other, both padded
    # to PLANAR_RAYS rows as the align gives them to the kernel
    g2d, l2d, _ = planar_pairs(n_pairs=1)[0]
    q2d = torch.where(planar_layers(l2d)["2d_lidar"].valid_mask()[:, None],
                      planar_layers(l2d)["2d_lidar"].xyz, 1.0e8).contiguous()
    p2d = torch.where(planar_layers(g2d)["2d_lidar"].valid_mask()[:, None],
                      planar_layers(g2d)["2d_lidar"].xyz, -1.0e8).contiguous()
    for k in (4, 5):
        errs["knn_bruteforce"].append(compare(f"K1 {PLANAR_RAYS}x{PLANAR_RAYS} k={k} (2D demo)",
                                         nnb.knn_sweep, nnb.knn_plain, q2d, p2d, k))
    # the YAML phase's new shapes: the 2D demo's generator layers (capacity
    # 1024), and the filter pipeline's normals fit (a decimated layer of
    # capacity 2^16 against itself)
    q1k, p1k = (sentinel_padded(generated_2d_layer(r), far)
                for r, far in zip(planar_range_pairs(n_pairs=1)[0][1::-1], (1.0e8, -1.0e8)))
    for k in (1, 5):
        errs["knn_bruteforce"].append(compare(f"K1 {q1k.shape[0]}x{p1k.shape[0]} k={k} (2D YAML)",
                                         nnb.knn_sweep, nnb.knn_plain, q1k, p1k, k))
    dec = yaml_pipeline_input_layer(scans_o[0])
    q64k, p64k = sentinel_padded(dec, 1.0e8), sentinel_padded(dec, -1.0e8)
    errs["knn_bruteforce"].append(compare(f"K1 {q64k.shape[0]}x{p64k.shape[0]} k=8 (YAML pipeline "
                                     f"normals, {int(dec.count)} valid)", nnb.knn_sweep,
                                     nnb.knn_plain, q64k, p64k, 8))
    res_gpu = nnb.knn_bruteforce(qr.to(dev), qv.to(dev), pr.to(dev), pv.to(dev), k=4,
                                 max_radius_sq=rad.to(dev))
    res_cpu = nnb.knn_bruteforce(qr, qv, pr, pv, k=4, max_radius_sq=rad)
    bad = knn_mismatch(qr.numpy(), pr.numpy(), res_gpu.idx.cpu().numpy(),
                       res_gpu.valid.cpu().numpy(), res_cpu.idx.numpy(),
                       res_cpu.dist_sq.numpy(), res_cpu.valid.numpy(),
                       radius_sq=rad.numpy())
    check(not bad.any(), f"777x3001 front end with radius: {bad.sum()} entries differ")
    print(f"[kernel] 777x3001 k=4 front end, invalid rows + per-query radius: ok "
          f"({int(res_gpu.valid.sum())} valid pairs, same as the CPU plain path: "
          f"{torch.equal(res_gpu.valid.cpu(), res_cpu.valid)})")

    # K3: the scan of the 2M-map case against the first 262144 map points
    corridor = corridor_scene(np.random.RandomState(33), 1 << 24)
    scan_q = torch.from_numpy(local_window(corridor, 200.0, np.random.RandomState(34))).to(dev)
    map_p = torch.from_numpy(corridor[: 1 << 18]).to(dev)
    for k in (1, 8):
        errs["knn_streamed"].append(compare(
            f"K3 8192x262144 k={k} corridor", nnb.knn_sweep_streamed,
            nnb.knn_plain_streamed, scan_q, map_p, k))
    n_rag = 200_003  # > STREAM_BLOCK, not a multiple of a slice
    q_rag = torch.where(torch.from_numpy(rng.rand(5000) > 0.1)[:, None].to(dev),
                        scan_q[:5000], 1.0e8).contiguous()
    p_rag = torch.where(torch.from_numpy(rng.rand(n_rag) > 0.1)[:, None].to(dev),
                        map_p[:n_rag], -1.0e8).contiguous()
    errs["knn_streamed"].append(compare(
        f"K3 5000x{n_rag} k=3 invalid rows ({tuple(nnb.sweep_split(5000, n_rag, nnb._sm_count(0), 3))})",
        nnb.knn_sweep_streamed, nnb.knn_plain_streamed, q_rag, p_rag, 3))

    # K2: 8 scans of the batched case against 8 maps of 65536 points, and
    # against one shared map
    scans_b = torch.stack([torch.from_numpy(local_window(
        corridor, 60.0 + 40.0 * b, np.random.RandomState(100 + b))) for b in range(BATCH)]).to(dev)
    maps_b = torch.stack([torch.from_numpy(corridor[(b << 16):((b + 1) << 16)])
                          for b in range(BATCH)]).to(dev)
    errs["knn_batched"].append(compare(
        f"K2 {BATCH}x8192x65536 k=1 batched maps", nnb.knn_sweep_batched,
        nnb.knn_plain_batched, scans_b, maps_b, 1))
    errs["knn_batched"].append(compare(
        f"K2 {BATCH}x8192x65536 k=1 shared map", nnb.knn_sweep_batched,
        nnb.knn_plain_batched, scans_b, maps_b[0], 1))
    # the launch a data-parallel rank makes with its half of the batch (the
    # split of the point axis depends on B)
    b_rank = BATCH // SPATIAL_RANKS
    errs["knn_batched"].append(compare(
        f"K2 {b_rank}x8192x65536 k=1 (a data-parallel rank's share)", nnb.knn_sweep_batched,
        nnb.knn_plain_batched, scans_b[:b_rank], maps_b[:b_rank], 1))
    # the B = 16 scan-to-scan batch (bench.py:219-253): each pair's local
    # scan against its own global scan, Adaptive's k = 1 as DistanceThreshold's
    pairs16 = [street_pair(scene, 100 + 2 * b, 101 + 2 * b) for b in range(PAIR_BATCH)]
    q16 = torch.stack([pl["raw"].xyz for pl, _ in pairs16]).contiguous()
    p16 = torch.stack([pg["raw"].xyz for _, pg in pairs16]).contiguous()
    errs["knn_batched"].append(compare(
        f"K2 {PAIR_BATCH}x{N_POINTS}x{N_POINTS} k=1 (the B = 16 scan-to-scan batch, each pair "
        f"its own map)", nnb.knn_sweep_batched, nnb.knn_plain_batched, q16, p16, 1))
    errs["knn_batched"].append(compare(
        f"K2 {BATCH}x777x3001 k=4 invalid rows", nnb.knn_sweep_batched,
        nnb.knn_plain_batched, qs.expand(BATCH, -1, -1).contiguous(),
        torch.stack([ps.roll(b, 0) for b in range(BATCH)]), 4))
    # the split of the point axis: ties everywhere, ragged Q, C below one
    # tile and below a block's warps, a misaligned batch stride, the
    # odometry shapes
    n_sm = nnb._sm_count(0)
    for k in (1, 8):
        for Q, C in ((5000, 20011), (1, 3001), (777, 100), (777, 3)):
            errs["knn_bruteforce"].append(compare(
                f"K1 {Q}x{C} k={k} integer grid (ties), (warps, slices, slice) "
                f"{tuple(nnb.sweep_split(Q, C, n_sm, k))}", nnb.knn_sweep, nnb.knn_plain,
                grid_points(rng, Q).to(dev), grid_points(rng, C).to(dev), k))
        for Q, C in ((5000, n_rag), (1, 140_000), (777, 100)):
            errs["knn_streamed"].append(compare(
                f"K3 {Q}x{C} k={k} integer grid (ties), (warps, slices, slice) "
                f"{tuple(nnb.sweep_split(Q, C, n_sm, k))}", nnb.knn_sweep_streamed,
                nnb.knn_plain_streamed, grid_points(rng, Q).to(dev),
                grid_points(rng, C).to(dev), k))
        for B, Q, C, shared in ((BATCH, 777, 3001, False), (2, 5000, 20011, True),
                                (3, 1, 100, False), (BATCH, 777, 3, False)):
            errs["knn_batched"].append(compare(
                f"K2 {B}x{Q}x{C} k={k} integer grid (ties){' shared map' if shared else ''}, "
                f"(warps, slices, slice) {tuple(nnb.sweep_split(Q, C, n_sm, k, B))}",
                nnb.knn_sweep_batched,
                nnb.knn_plain_batched, grid_points(rng, B, Q).to(dev),
                grid_points(rng, *(() if shared else (B,)), C).to(dev), k))
    odo_q, odo_p = scan_q[:6144].contiguous(), map_p[: 1 << 14].contiguous()
    errs["knn_bruteforce"].append(compare("K1 6144x16384 k=1 (odometry step)", nnb.knn_sweep,
                                     nnb.knn_plain, odo_q, odo_p, 1))
    # the normals fit of a frame: 2048 new voxels against the crop + the
    # scan; of the seed: the first scan against itself
    fit_q, fit_p = odo_q[:2048].contiguous(), torch.cat([odo_p, odo_q]).contiguous()
    errs["knn_bruteforce"].append(compare("K1 2048x22528 k=8 (odometry normals fit)", nnb.knn_sweep,
                                     nnb.knn_plain, fit_q, fit_p, 8))
    errs["knn_bruteforce"].append(compare("K1 6144x6144 k=8 (odometry seed's normals fit)",
                                     nnb.knn_sweep, nnb.knn_plain, odo_q, odo_q, 8))
    # the fleet step: stream b's queries are returns of street frame 2b, its
    # map the returns of the next frame; the fit takes 2048 of the queries
    # against map + scan
    returns = [torch.from_numpy(sc["xyz"][sc["valid"]]) for sc in scans_o[:2 * BATCH]]
    fleet_q = torch.stack([returns[2 * b][:6144] for b in range(BATCH)]).to(dev)
    fleet_p = torch.stack([returns[2 * b + 1][: 1 << 14] for b in range(BATCH)]).to(dev)
    fleet_fq = fleet_q[:, :2048].contiguous()
    fleet_fp = torch.cat([fleet_p, fleet_q], dim=1).contiguous()
    errs["knn_batched"].append(compare(
        f"K2 {BATCH}x6144x16384 k=1 (fleet step, street scans)", nnb.knn_sweep_batched,
        nnb.knn_plain_batched, fleet_q, fleet_p, 1))
    errs["knn_batched"].append(compare(
        f"K2 {BATCH}x2048x22528 k=8 (fleet normals fit, street scans)", nnb.knn_sweep_batched,
        nnb.knn_plain_batched, fleet_fq, fleet_fp, 8))
    n_before = dict(COMPARED)
    counted_cases(errs, dev, scan_q, map_p, rng)
    # the YAML pipeline's normals fit as its front end calls it: with the counts
    n64k = (row_counts(q64k), row_counts(p64k))
    launch_line(1, q64k.shape[0], p64k.shape[0], 8, n64k)
    errs["knn_bruteforce"].append(compare(
        f"K1 {q64k.shape[0]}x{p64k.shape[0]} k=8 (YAML pipeline normals) counted "
        f"{int(n64k[0])} x {int(n64k[1])}", nnb.knn_sweep, nnb.knn_plain, q64k, p64k, 8, *n64k))
    print(f"[kernel] phase 3: {n_before['without counts']} compare cases without counts (as "
          f"before counts), {COMPARED['with counts'] - n_before['with counts']} with counts, "
          f"all bit-equal")
    torch.cuda.synchronize()
    for Q, C, k, B in ((6144, 1 << 14, 1, 1), (2048, 22528, 8, 1), (6144, 6144, 8, 1),
                       (N_POINTS, N_POINTS, 1, 1),
                       (N_POINTS, 1 << 16, 1, 1), (N_POINTS, 1 << 18, 1, 1),
                       (N_POINTS, 1 << 16, 1, BATCH), (N_POINTS, N_POINTS, 1, PAIR_BATCH),
                       (6144, 1 << 14, 1, BATCH), (2048, 22528, 8, BATCH)):
        # the grid and block sizes as the built library forms them for the
        # wrapper's split and register tile, beside the wrapper's own
        # arithmetic
        blocks, warps = launch_line(B, Q, C, k)
        shape = nnb.launch_shape(Q, C, n_sm, k, B)
        check((blocks, warps) == (shape["blocks"], shape["warps"]),
              f"{B}x{Q}x{C}: the library launches {blocks} blocks, {warps} warps; "
              f"the wrapper counts {shape['blocks']}, {shape['warps']}")
        check(warps / n_sm >= 15.5, f"{B}x{Q}x{C}: under ~16 warps per SM")

    # ---- times, in turns: (kernel, label, B, Q, C, k, kernel call, plain call)
    map_64k = maps_b[1]
    timed = [
        ("knn_bruteforce", "scan to scan", 1, N_POINTS, N_POINTS, 1,
         lambda: nnb.knn_sweep(q, p, 1), lambda: nnb.knn_plain(q, p, 1)),
        ("knn_bruteforce", "scan to scan k=8, Adaptive's plane stage", 1, N_POINTS, N_POINTS, 8,
         lambda: nnb.knn_sweep(q, p, 8), lambda: nnb.knn_plain(q, p, 8)),
        ("knn_bruteforce", "2D demo, Point2Line", 1, PLANAR_RAYS, PLANAR_RAYS, 5,
         lambda: nnb.knn_sweep(q2d, p2d, 5), lambda: nnb.knn_plain(q2d, p2d, 5)),
        ("knn_bruteforce", "Point2Line's default k", 1, PLANAR_RAYS, PLANAR_RAYS, 4,
         lambda: nnb.knn_sweep(q2d, p2d, 4), lambda: nnb.knn_plain(q2d, p2d, 4)),
        ("knn_bruteforce", "2D demo, DistanceThreshold", 1, PLANAR_RAYS, PLANAR_RAYS, 1,
         lambda: nnb.knn_sweep(q2d, p2d, 1), lambda: nnb.knn_plain(q2d, p2d, 1)),
        ("knn_bruteforce", "odometry step", 1, 6144, 1 << 14, 1,
         lambda: nnb.knn_sweep(odo_q, odo_p, 1), lambda: nnb.knn_plain(odo_q, odo_p, 1)),
        ("knn_bruteforce", "odometry normals fit", 1, 2048, 22528, 8,
         lambda: nnb.knn_sweep(fit_q, fit_p, 8), lambda: nnb.knn_plain(fit_q, fit_p, 8)),
        ("knn_bruteforce", "odometry seed's normals fit", 1, 6144, 6144, 8,
         lambda: nnb.knn_sweep(odo_q, odo_q, 8), lambda: nnb.knn_plain(odo_q, odo_q, 8)),
        ("knn_bruteforce", "1M-map crop", 1, N_POINTS, 1 << 16, 1,
         lambda: nnb.knn_sweep(scan_q, map_64k, 1), lambda: nnb.knn_plain(scan_q, map_64k, 1)),
        ("knn_bruteforce", "K1 on K3's shape", 1, N_POINTS, 1 << 18, 1,
         lambda: nnb.knn_sweep(scan_q, map_p, 1), lambda: nnb.knn_plain(scan_q, map_p, 1)),
        ("knn_streamed", "2M-map crop", 1, N_POINTS, 1 << 18, 1,
         lambda: nnb.knn_sweep_streamed(scan_q, map_p, 1),
         lambda: nnb.knn_plain_streamed(scan_q, map_p, 1)),
        ("knn_streamed", "2M-map crop k=8", 1, N_POINTS, 1 << 18, 8,
         lambda: nnb.knn_sweep_streamed(scan_q, map_p, 8),
         lambda: nnb.knn_plain_streamed(scan_q, map_p, 8)),
        ("knn_batched", "batched", BATCH, N_POINTS, 1 << 16, 1,
         lambda: nnb.knn_sweep_batched(scans_b, maps_b, 1),
         lambda: nnb.knn_plain_batched(scans_b, maps_b, 1)),
        ("knn_batched", "batched, shared map", BATCH, N_POINTS, 1 << 16, 1,
         lambda: nnb.knn_sweep_batched(scans_b, map_64k, 1),
         lambda: nnb.knn_plain_batched(scans_b, map_64k, 1)),
        ("knn_batched", "the B = 16 scan-to-scan batch, each pair its own map",
         PAIR_BATCH, N_POINTS, N_POINTS, 1,
         lambda: nnb.knn_sweep_batched(q16, p16, 1),
         lambda: nnb.knn_plain_batched(q16, p16, 1)),
        ("knn_batched", "batched B=2", 2, N_POINTS, 1 << 16, 1,
         lambda: nnb.knn_sweep_batched(scans_b[:2], maps_b[:2], 1),
         lambda: nnb.knn_plain_batched(scans_b[:2], maps_b[:2], 1)),
        ("knn_batched", "B=4, a data-parallel rank's half of the batch", 4, N_POINTS,
         1 << 16, 1, lambda: nnb.knn_sweep_batched(scans_b[:4], maps_b[:4], 1),
         lambda: nnb.knn_plain_batched(scans_b[:4], maps_b[:4], 1)),
        ("knn_batched", "fleet step", BATCH, 6144, 1 << 14, 1,
         lambda: nnb.knn_sweep_batched(fleet_q, fleet_p, 1),
         lambda: nnb.knn_plain_batched(fleet_q, fleet_p, 1)),
        ("knn_batched", "fleet normals fit", BATCH, 2048, 22528, 8,
         lambda: nnb.knn_sweep_batched(fleet_fq, fleet_fp, 8),
         lambda: nnb.knn_plain_batched(fleet_fq, fleet_fp, 8)),
        ("knn_bruteforce", "2D YAML, Point2Line (a generator's layer)", 1, 1024, 1024, 5,
         lambda: nnb.knn_sweep(q1k, p1k, 5), lambda: nnb.knn_plain(q1k, p1k, 5)),
        ("knn_bruteforce", "2D YAML, DistanceThreshold", 1, 1024, 1024, 1,
         lambda: nnb.knn_sweep(q1k, p1k, 1), lambda: nnb.knn_plain(q1k, p1k, 1)),
        ("knn_bruteforce", "YAML filter pipeline, normals", 1, 1 << 16, 1 << 16, 8,
         lambda: nnb.knn_sweep(q64k, p64k, 8, *n64k),
         lambda: nnb.knn_plain(q64k, p64k, 8, *n64k)),
    ]
    # the operands of each row, for its library call
    operands = [(q, p), (q, p), (q2d, p2d), (q2d, p2d), (q2d, p2d), (odo_q, odo_p),
                (fit_q, fit_p), (odo_q, odo_q), (scan_q, map_64k), (scan_q, map_p),
                (scan_q, map_p), (scan_q, map_p), (scans_b, maps_b), (scans_b, map_64k),
                (q16, p16), (scans_b[:2], maps_b[:2]), (scans_b[:4], maps_b[:4]), (fleet_q, fleet_p), (fleet_fq, fleet_fp), (q1k, p1k),
                (q1k, p1k), (q64k, p64k, n64k)]  # a third field: the counts the call passes
    check(len(operands) == len(timed), "a timed row without its operands")
    graph_times = [[] for _ in timed]
    for _ in range(2):  # two turns over all shapes
        for at, case in enumerate(timed):
            graph_times[at] += graph_ms(case[6])
    shapes = {name: [] for name in cuda_build.LIBRARIES}
    for (name, label, B, Q, C, k, run, plain), g_times, (lq, lp, *n) in zip(timed, graph_times,
                                                                             operands):
        shapes[name].append(kernel_row(name, label, B, Q, C, k, run, plain, lq, lp, g_times,
                                       smi, counts=n[0] if n else None))

    def eight_k1():
        for b in range(BATCH):
            nnb.knn_sweep(scans_b[b], maps_b[b], 1)

    print(f"[time] aside: {BATCH} K1 launches for the batched shape "
          f"{statistics.median(graph_ms(eight_k1)):.4f} ms in a CUDA graph on {smi}")
    del maps_b, map_64k, timed, q16, p16

    phase_done("kernels against their plain versions, times")
    shapes["gn_solve"], errs["gn_solve"] = gn_phase(smi)
    phase_done("Gauss-Newton kernel")
    shapes["icp_terminate"], errs["icp_terminate"] = terminate_phase(smi)
    phase_done("termination kernel")
    launches = {name: 0 for name in cuda_build.LIBRARIES}
    by_path = {name: {} for name in cuda_build.LIBRARIES}  # launches of each path's last counted window

    # ---- 4. the scan-to-scan path
    icp = kitti_icp()
    params = ICPParameters(max_iterations=40)
    gt = se3.from_xyz_ypr(*GT)
    requests = [(1, 2)] + [(100 + 2 * b, 101 + 2 * b) for b in range(N_REQUESTS)]
    pairs = [street_pair(scene, sg, sl) for sg, sl in requests]
    torch.cuda.synchronize()
    reset_counts()
    expected = 0
    results, wall = [], []
    for loc_l, glob_l in pairs:
        t0 = time.perf_counter()
        res = icp.align(loc_l, glob_l, se3.identity(), params)
        err = float(se3.error_log_norm(gt, res.optimal_tf))  # syncs
        wall.append(time.perf_counter() - t0)
        results.append((res, err))
        expected += matcher_calls(icp, res.n_iterations)
    n = counts()
    check(n["knn_bruteforce"] == expected and expected > 0,
          f"K1 launches {n['knn_bruteforce']} != matcher calls {expected}")
    check(n["knn_streamed"] == n["knn_batched"] == 0, f"other kernels ran: {n}")
    launches["knn_bruteforce"] += n["knn_bruteforce"]
    by_path["knn_bruteforce"][f"scan to scan, {len(pairs)} aligns"] = n["knn_bruteforce"]
    count_own(launches, by_path, n, f"scan to scan, {len(pairs)} aligns")

    res, err = results[0]
    print(f"[align] KITTI config, bench pair {N_POINTS} pts on {kind}: SE(3) error "
          f"{err:.6f}, {res.n_iterations} iterations, {res.termination_reason.name}, "
          f"quality {float(res.quality):.6f}, {wall[0] * 1e3:.1f} ms (first call) "
          f"[JAX CPU reference: 0.00222, 12, STALLED, 0.872]")
    check(err < ERR_LIMIT, f"SE(3) error {err} >= {ERR_LIMIT}")
    for b, ((r, e), w) in enumerate(zip(results[1:], wall[1:])):
        print(f"[serve] pair {b}: error {e:.6f}, {r.n_iterations} iterations, "
              f"{r.termination_reason.name}, {w * 1e3:.1f} ms")
        check(e < ERR_LIMIT, f"pair {b}: SE(3) error {e} >= {ERR_LIMIT}")
    serve_s = sum(wall[1:])
    median_ms = statistics.median(wall[1:]) * 1e3
    print(f"[serve] {N_REQUESTS} pairs in {serve_s:.3f} s: "
          f"{N_REQUESTS / serve_s:.2f} aligns/s, median {median_ms:.1f} ms/align on {smi}")
    print(f"[count] K1 launches {n['knn_bruteforce']} == matcher calls {expected}")

    loc_c = {"raw": PointCloud(loc["raw"].xyz.cpu(), loc["raw"].count.cpu())}
    glob_c = {"raw": PointCloud(glob["raw"].xyz.cpu(), glob["raw"].count.cpu())}
    t0 = time.perf_counter()
    res_c = icp.align(loc_c, glob_c, se3.identity(device="cpu"), params)
    cpu_s = time.perf_counter() - t0
    gap = float(se3.error_log_norm(
        se3.Pose(res_c.optimal_tf.R.to(dev), res_c.optimal_tf.t.to(dev)), res.optimal_tf))
    print(f"[cpu] same pair on the CPU plain path: {res_c.n_iterations} iterations, "
          f"{res_c.termination_reason.name}, pose gap to the GPU result {gap:.3g} "
          f"({cpu_s:.1f} s)")
    check(gap < 5e-3, f"CPU/GPU pose gap {gap}")

    phase_done("scan to scan")
    # ---- 5. the scan-to-large-map path
    micp = map_icp()
    scan_l, sensor, gt_map = sensor_scan(corridor, 200.0, 34,
                                         (0.9, 0.2, 0.02, 0.02, 0.003, -0.004))
    maps, map_results = {}, {}
    for label, n_map, crop, (j_err, j_it, j_reason) in MAP_CASES:
        gmap = {"map": PointCloud.from_numpy(corridor[:n_map], capacity=n_map)}
        mparams = ICPParameters(max_iterations=40, crop_capacity=crop, crop_extra_margin=4.0)
        kernel = "knn_streamed" if crop > nnb.STREAM_BLOCK else "knn_bruteforce"
        micp._crop_globals(mparams, gmap, scan_l, sensor)  # warm-up: first use of its ops
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cropped, _ = micp._crop_globals(mparams, gmap, scan_l, sensor)
        torch.cuda.synchronize()
        crop_ms = (time.perf_counter() - t0) * 1e3
        n_kept = int(cropped["map"].count)
        reset_counts()
        walls, res = timed_aligns(micp, scan_l, gmap, mparams, 1 + MAP_TIMED[label], sensor)
        n = counts()
        calls = (1 + MAP_TIMED[label]) * matcher_calls(micp, res.n_iterations)
        check(n[kernel] == calls and calls > 0,
              f"{label}: {kernel} launches {n[kernel]} != matcher calls {calls}")
        check(knn_launches(n) == n[kernel], f"{label}: other kernels ran: {n}")
        launches[kernel] += n[kernel]
        by_path[kernel][f"scan to the {label} map, {1 + MAP_TIMED[label]} aligns"] = n[kernel]
        count_own(launches, by_path, n, f"scan to the {label} map, {1 + MAP_TIMED[label]} aligns")
        err = float(se3.error_log_norm(gt_map, res.optimal_tf))
        warm = walls[1:]
        print(f"[map] {label} map, crop {crop} ({n_kept} points kept, crop {crop_ms:.1f} ms) "
              f"on {kind}: SE(3) error {err:.6f}, {res.n_iterations} iterations, "
              f"{res.termination_reason.name} [JAX CPU reference: {j_err}, {j_it}, "
              f"{j_reason}]; first align {walls[0] * 1e3:.1f} ms, {len(warm)} warm aligns "
              f"median {statistics.median(warm) * 1e3:.1f} ms, {len(warm) / sum(warm):.2f} "
              f"aligns/s on {smi}")
        print(f"[count] {label}: {kernel} launches {n[kernel]} == matcher calls {calls}")
        check(err < ERR_LIMIT, f"{label} map: SE(3) error {err} >= {ERR_LIMIT}")
        maps[label] = (gmap, mparams)
        map_results[label] = (res, statistics.median(warm) * 1e3)
    map_1m = maps["1M"][0]

    phase_done("scan to large maps")
    # ---- 6. the batched path: B scans against the shared 1M map
    rngb = np.random.RandomState(35)
    problems = []
    for b in range(BATCH):
        cx = 60.0 + 280.0 * b / (BATCH - 1)
        ge = (0.9 * rngb.uniform(-1, 1), 0.2 * rngb.uniform(-1, 1), 0.02,
              0.02 * rngb.uniform(-1, 1), 0.003, -0.004)
        problems.append(sensor_scan(corridor, cx, 100 + b, ge))
    bparams = ICPParameters(max_iterations=40, crop_capacity=1 << 16, crop_extra_margin=4.0)
    fn = make_batched_align(micp, bparams, broadcast_globals=True)
    l_b = stack_pytrees([pr_[0] for pr_ in problems])
    g_b = stack_pytrees([pr_[1] for pr_ in problems])
    b_walls = []
    for rep in range(3):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rb = fn(l_b, map_1m, g_b)
        float(rb.optimal_tf.t[0, 0])  # syncs
        b_walls.append(time.perf_counter() - t0)
        n = counts()
        calls = matcher_calls(micp, int(rb.n_iterations.max()))
        check(n["knn_batched"] == calls and calls > 0,
              f"batched: K2 launches {n['knn_batched']} != matcher calls {calls}")
        check(n["knn_bruteforce"] == n["knn_streamed"] == 0,
              f"batched: K1/K3 launched during the batched call: {n}")
        launches["knn_batched"] += n["knn_batched"]
        by_path["knn_batched"]["batched call"] = n["knn_batched"]
        count_own(launches, by_path, n, "batched call")
    print(f"[count] batched: K2 launches {n['knn_batched']} == matcher calls {calls} "
          f"per call, K1 and K3 launches 0")
    seq_walls = []
    for b, (scan_b, guess_b, gt_b) in enumerate(problems):
        pose_b = se3.Pose(rb.optimal_tf.R[b], rb.optimal_tf.t[b])
        err = float(se3.error_log_norm(gt_b, pose_b))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq = micp.align(scan_b, map_1m, guess_b, bparams)
        gap = max(float((seq.optimal_tf.R - pose_b.R).abs().max()),
                  float((seq.optimal_tf.t - pose_b.t).abs().max()))
        seq_walls.append(time.perf_counter() - t0)
        it_b, reason_b = int(rb.n_iterations[b]), int(rb.termination_reason[b])
        print(f"[batch] problem {b}: SE(3) error {err:.6f}, {it_b} iterations, "
              f"{IterTermReason(reason_b).name} [JAX CPU reference: {BATCH_JAX_ITERS[b]} "
              f"iterations, STALLED]; sequential align: {seq.n_iterations} iterations, "
              f"{seq.termination_reason.name}, max |R, t difference| {gap:.3g}")
        check(err < ERR_LIMIT, f"batched problem {b}: SE(3) error {err} >= {ERR_LIMIT}")
        check(gap < 1e-5, f"batched problem {b}: pose differs from sequential by {gap}")
        check(it_b == seq.n_iterations and reason_b == seq.termination_reason,
              f"batched problem {b}: iterations/termination differ from sequential")
    warm_b = b_walls[1:]
    print(f"[batch] {BATCH} scans vs the shared 1M map in one call: first "
          f"{b_walls[0] * 1e3:.1f} ms, warm {[round(w * 1e3, 1) for w in warm_b]} ms, "
          f"{BATCH * len(warm_b) / sum(warm_b):.2f} scans/s; the same scans aligned one "
          f"after another {BATCH / sum(seq_walls):.2f} scans/s on {smi}")
    # the B = 16 scan-to-scan batch (bench.py:219-253): each pair its own
    # map, no broadcast; phase 4 aligned the first N_REQUESTS pairs one by one
    fn16 = make_batched_align(icp, params)
    l16 = stack_pytrees([pl for pl, _ in pairs16])
    g16 = stack_pytrees([pg for _, pg in pairs16])
    u16 = stack_pytrees([se3.identity() for _ in pairs16])
    walls16 = []
    for rep in range(2):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r16 = fn16(l16, g16, u16)
        float(r16.optimal_tf.t[0, 0])  # syncs
        walls16.append(time.perf_counter() - t0)
        n = counts()
        calls = matcher_calls(icp, int(r16.n_iterations.max()))
        check(n["knn_batched"] == calls and calls > 0,
              f"B = 16 pairs: K2 launches {n['knn_batched']} != matcher calls {calls}")
        check(n["knn_bruteforce"] == n["knn_streamed"] == 0,
              f"B = 16 pairs: K1/K3 launched during the batched call: {n}")
        launches["knn_batched"] += n["knn_batched"]
        by_path["knn_batched"][f"B = {PAIR_BATCH} scan-to-scan call"] = n["knn_batched"]
        count_own(launches, by_path, n, f"B = {PAIR_BATCH} scan-to-scan call")
    print(f"[count] B = {PAIR_BATCH} pairs: K2 launches {n['knn_batched']} == matcher "
          f"calls {calls} per call, K1 and K3 launches 0")
    seq16 = [r for r, _ in results[1:]]
    for loc_l, glob_l in pairs16[len(seq16):]:
        seq16.append(icp.align(loc_l, glob_l, se3.identity(), params))
    for b, seq in enumerate(seq16):
        pose_b = se3.Pose(r16.optimal_tf.R[b], r16.optimal_tf.t[b])
        err = float(se3.error_log_norm(gt, pose_b))
        gap = max(float((seq.optimal_tf.R - pose_b.R).abs().max()),
                  float((seq.optimal_tf.t - pose_b.t).abs().max()))
        it_b, reason_b = int(r16.n_iterations[b]), int(r16.termination_reason[b])
        print(f"[batch16] pair {b}: SE(3) error {err:.6f}, {it_b} iterations, "
              f"{IterTermReason(reason_b).name}; sequential align: {seq.n_iterations} "
              f"iterations, {seq.termination_reason.name}, max |R, t difference| {gap:.3g}")
        check(err < ERR_LIMIT, f"B = 16 pair {b}: SE(3) error {err} >= {ERR_LIMIT}")
        check(gap < 1e-5, f"B = 16 pair {b}: pose differs from sequential by {gap}")
        check(it_b == seq.n_iterations and reason_b == seq.termination_reason,
              f"B = 16 pair {b}: iterations/termination differ from sequential")
    print(f"[batch16] {PAIR_BATCH} scan-to-scan pairs, each its own map, in one call: first "
          f"{walls16[0] * 1e3:.1f} ms, warm {walls16[1] * 1e3:.1f} ms, "
          f"{PAIR_BATCH / walls16[1]:.2f} scans/s on {smi}")

    phase_done("batched")
    # ---- 7. the odometry path: the street drive, frame by frame
    frames_o = odometry_frames(scans_o)
    pose0_o = pose_of(gt_o[0])
    mapper = odometry_mapper()
    print(f"[odometry] {int(frames_o[0]['raw'].count)} returns in frame 0, raw capacity "
          f"{frames_o[0]['raw'].capacity}")
    runs_o = []
    for rep in range(2):  # once cold, once warm
        torch.cuda.synchronize()
        reset_counts()
        r = mapper.run(frames_o, twists=twists_o, dt=ODO_DT, initial_pose=pose0_o)
        torch.cuda.synchronize()
        n = counts()
        # one kNN per ICP iteration, one normals fit per frame, the seed's
        calls = (sum(matcher_calls(mapper.icp, int(it)) for it in r["iterations"])
                 + (ODO_FRAMES - 1) + 1)
        check(n["knn_bruteforce"] == calls,
              f"odometry: K1 launches {n['knn_bruteforce']} != matcher calls + normals fits {calls}")
        check(n["knn_streamed"] == n["knn_batched"] == 0,
              f"odometry: K2/K3 launched: {n}")
        launches["knn_bruteforce"] += n["knn_bruteforce"]
        by_path["knn_bruteforce"][f"odometry, one run of {ODO_FRAMES} frames"] = n["knn_bruteforce"]
        count_own(launches, by_path, n, f"odometry, one run of {ODO_FRAMES} frames")
        # every solve of the mapper's ICP (Point2Plane, plain GNParams) takes the
        # kernel, and every termination test the other
        for name in ("gn_solve", "icp_terminate"):
            check(n[name] == int(r["iterations"].sum()),
                  f"odometry: {name} kernel launches {n[name]} != ICP iterations "
                  f"{int(r['iterations'].sum())}")
        ate = ate_rmse(r["poses"], gt_o)
        n_map = int(r["map"].count)
        frame_ms = r["frame_seconds"] * 1e3
        new_voxels = np.diff(r["map_counts"])
        print(f"[odometry] run {rep} ({'cold' if rep == 0 else 'warm'}) on {kind}: "
              f"{r['scans_per_s']:.2f} scans/s, ms per frame median {np.median(frame_ms):.1f} "
              f"max {frame_ms.max():.1f}; ICP iterations per frame mean "
              f"{r['iterations'].mean():.2f} max {r['iterations'].max()}; ATE {ate:.4f} m, "
              f"map {n_map} points, new voxels per frame mean {new_voxels.mean():.0f} "
              f"({r['map_counts'][0]} after frame 1), dropped {int(r['map_state'].n_dropped)} "
              f"[JAX CPU reference: ATE {ODO_JAX['ate_m']} m, {ODO_JAX['map_points']} points, "
              f"{ODO_JAX['iterations_mean']} iterations per frame] on {smi}")
        print(f"[count] odometry run {rep}: K1 launches {n['knn_bruteforce']} == "
              f"{int(r['iterations'].sum())} matcher calls + {ODO_FRAMES - 1} normals fits "
              f"+ 1 (the seed's); K2 and K3 launches 0")
        check(r["poses"].shape == (ODO_FRAMES, 4, 4) and np.isfinite(r["poses"]).all(),
              "odometry: poses not finite")
        check(np.isfinite(r["qualities"]).all() and len(r["qualities"]) == ODO_FRAMES - 1,
              "odometry: a frame's quality is not finite")
        check(ate < ATE_LIMIT, f"odometry: ATE {ate} m >= {ATE_LIMIT}")
        check(ate <= max(1.5 * ODO_JAX["ate_m"], ODO_JAX["ate_m"] + 0.01),
              f"odometry: ATE {ate} m outside max(1.5 x, + 0.01 m) of the JAX CPU "
              f"reference {ODO_JAX['ate_m']}")
        check(abs(n_map - ODO_JAX["map_points"]) <= 0.02 * ODO_JAX["map_points"],
              f"odometry: {n_map} map points, not within 2% of {ODO_JAX['map_points']}")
        runs_o.append(r)
    spread = max(float(np.abs(runs_o[0]["poses"] - r["poses"]).max()) for r in runs_o[1:])
    print(f"[odometry] largest difference between the two runs' poses: {spread:.3g}")
    # the map insert twice on the same input: equal states, dest included
    seed_o = mapper.seed_map(frames_o[0], pose0_o, twists_o[0])
    scan_1 = mapper._local(frames_o[1], torch.from_numpy(twists_o[1]).to(dev)).transformed(
        pose_of(runs_o[0]["poses"][1]))
    first, dest_a = hash_map_insert(seed_o, scan_1, ODO_RESOLUTION, with_dest=True)
    again, dest_b = hash_map_insert(seed_o, scan_1, ODO_RESOLUTION, with_dest=True)
    check(states_equal(first, again) and torch.equal(dest_a, dest_b),
          "odometry: the same insert twice gave two states")
    check(int(first.pc.count) > int(seed_o.pc.count), "odometry: the insert added nothing")
    print(f"[odometry] the map insert of frame 1 run twice on the same state: equal states "
          f"and rows ({int(seed_o.pc.count)} -> {int(first.pc.count)} points)")

    phase_done("odometry")
    # ---- 8. the fleet path: 8 streams of the drive, one frame index at a time
    fleet = fleet_phase(mapper, frames_o, twists_o, gt_o, runs_o[-1], launches, by_path, smi, kind)

    phase_done("fleet")
    # ---- 9. the rest of the engine
    _, engine_runs, engine_planar = engine_phase(smi, kind, launches, by_path)

    phase_done("engine")
    # ---- 10. map building from keyframes, the sm2mm demo
    global SM2MM_JAX, YAML_JAX
    reference = json.loads(SM2MM_REFERENCE.read_text())
    SM2MM_JAX, YAML_JAX = reference["sm2mm"], reference["yaml"]
    tables = []
    pass1 = sm2mm_phase(smi, kind, launches, by_path, gt_o, twists_o, scans_o, tables)

    phase_done("sm2mm")
    # ---- 11. the YAML pipelines
    yaml_phase(smi, kind, launches, by_path, scene, scans_o, engine_planar)

    phase_done("yaml")
    # ---- 12. the command-line entry points
    global APPS_JAX
    APPS_JAX = json.loads(APPS_REFERENCE.read_text())
    apps_scans = apps_phase(smi, kind, launches, by_path, errs, shapes, pass1)

    phase_done("apps")
    # ---- 13. the map tools
    global TOOLS_JAX
    TOOLS_JAX = json.loads(TOOLS_REFERENCE.read_text())
    tools_phase(smi, kind, launches, by_path, errs, shapes, apps_scans, pass1)
    del apps_scans

    phase_done("tools")
    # ---- 14. the pose graph, loop closure and the sharded paths
    global PARALLEL_JAX
    PARALLEL_JAX = json.loads(PARALLEL_REFERENCE.read_text())
    one_rank = pose_graph_phase(smi, kind)
    phase_done("pose graph")
    loop_closure_phase(smi, kind, launches, by_path)
    phase_done("loop closure")
    align_cases = {label: (micp, maps[label][1], scan_l, maps[label][0], sensor,
                           *map_results[label]) for label in ("1M", "2M")}
    # the 1M map with a crop that keeps every in-box row, in one process and
    # in each shard: the case where the sharded align must equal it to the bit
    params_wide = dataclasses.replace(maps["1M"][1], crop_capacity=1 << 19)
    walls, res_wide = timed_aligns(micp, scan_l, map_1m, params_wide, 3, sensor)
    align_cases["1M, crop 2^19"] = (micp, params_wide, scan_l, map_1m, sensor, res_wide,
                                    statistics.median(walls[1:]) * 1e3)
    batch_case = (micp, bparams, [layer_numpy_dict(pr_[0]) for pr_ in problems],
                  layer_numpy_dict(map_1m), [np_pose(pr_[1]) for pr_ in problems], rb,
                  statistics.median(warm_b) * 1e3)
    odometry_case = (mapper, [layer_numpy_dict(f) for f in frames_o], twists_o, gt_o, runs_o[-1])
    parallel_phase(smi, kind, launches, by_path, one_rank,
                   (scan_q.cpu().numpy(), corridor[: 1 << 20], (1, 8)), align_cases, batch_case,
                   odometry_case)
    phase_done("sharded paths")
    # ---- 15. the batched align on a data x space mesh
    mesh_phase(smi, kind, launches, by_path, errs, shapes, micp, bparams, problems, map_1m,
               rb, statistics.median(warm_b) * 1e3)
    phase_done("data x space")
    # ---- 16. bench_torch.py, the port's benchmark, at full size
    bench_phase(smi, launches, by_path)
    phase_done("bench_torch.py")
    # ---- 17. profile (optional)
    if args.profile:
        profile_align(icp, loc, glob, params, smi, tables)
        gmap_2m, params_2m = maps["2M"]
        profile_window("scan to the 2M map (K3)", lambda: float(micp.align(
            scan_l, gmap_2m, sensor, params_2m).optimal_tf.t[0]), 2, smi, tables)
        profile_window(f"batched, {BATCH} scans vs the 1M map (K2)", lambda: float(
            fn(l_b, map_1m, g_b).optimal_tf.t[0, 0]), 2, smi, tables)
        profile_odometry(mapper, frames_o, twists_o, pose0_o, smi, tables)
        profile_fleet(*fleet, smi, tables)
        for label, run in engine_runs.items():
            profile_window(label, run, 2, smi, tables)
        profile_engine(engine_runs["engine 3D, no hook"], smi)
        out = pathlib.Path(__file__).resolve().parent / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "profile_tables.txt").write_text("\n\n".join(tables))

    phase_done("profile")
    print(f"[kernel] compare cases of the run: {COMPARED['without counts']} without counts, "
          f"{COMPARED['with counts']} with counts, every one bit-equal to its plain version")
    # ---- 18. results
    # a kernel's own line is its first shape (the one its path gives it)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source(name),
        "replaces": REPLACES[name],
        "launches": launches[name],
        "launches_by_path": by_path[name],
        "max_abs_err": max(errs[name]),
        **{key: shapes[name][0][key] for key in
           ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound", "library_ms")},
        "shapes": shapes[name],
    } for name in cuda_build.LIBRARIES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
