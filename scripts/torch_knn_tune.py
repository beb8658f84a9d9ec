#!/usr/bin/env python3
"""Time the launch forms of the port's kNN sweep on one NVIDIA GPU, hold the
counted sweep and the k > 1 form against the kernels before them, and count
the instructions of the inner loop.

    python3 scripts/torch_knn_tune.py [--set NAME=VALUE[,NAME=VALUE] ...]
                                      [--baseline-csrc DIR] [--no-forms]

What it does (every line names the card and its power limit):

1. builds ``csrc/knn_batched.cu`` (the entry point that takes every launch
   parameter: problems, warps per block, slices, counts) and prints the
   ptxas report of its k = 1 and k = 8 kernels (registers, spills, shared
   memory);
2. at the shapes the ported paths and the odometry step use (``SHAPES``,
   on chip_smoke.py phase 3's inputs where ``SMOKE_DATA`` names them), times the form
   that the wrappers' rule (``nn_bruteforce.split_chunks``) chooses and
   (unless ``--no-forms``) a grid of forms (``nn_bruteforce.split_form``): G
   warps per block x a target of warps per SM, and the one-launch form (16
   warps, no slices). A time is the device time per launch in a CUDA graph
   (``chip_smoke.graph_ms``), the median of its replays, beside the bound
   (``chip_smoke.bound_ms``);
3. the rows of PERF.md section 6 (``ROWS``): each kernel through its
   wrapper as the paths call it, the padded shapes with the counts of their
   valid rows (a prefix of the capacity; the rest the front ends'
   sentinels), each checked bit for bit against the counted plain version;
   with ``--baseline-csrc DIR`` (a ``csrc/`` whose entry points take
   warps and slices but no counts, e.g. the parent commit's) the same rows
   through that build, uncounted and laid out by its own register tile, in
   turns: baseline, this build, this build, baseline;
4. with ``--set`` (e.g. ``--set kShareGroups=16 --set kStages=3,kTile=256``):
   for each, builds a copy of the sources with those constants of
   ``knn_sweep.cuh`` replaced, holds it against ``knn_plain_batched`` on
   tie-heavy cases and times the rule's form with it at ``SHAPES``, in
   turns with the sources as they are (the register tiles stay those of
   ``register_tile``; the grid of forms times each of them);
5. disassembles each build (``cuobjdump -sass``), finds the inner loop of
   the k = 1 and k = 8 sweep kernels (the backward branch spanning at least
   12 FMUL with the most FMUL per instruction) and counts its instructions
   per pair.

Results: stdout, ``chiprun_out/knn_tune.log``, ``chiprun_out/knn_tune.json``
and the SASS of the two kernels in ``chiprun_out/knn_sweep_k{1,8}.sass``.
"""

import argparse
import collections
import ctypes
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (bound_ms, corridor_scene, graph_ms, grid_points,  # noqa: E402
                        local_window, work_bound_ms)
from mp2p_icp_tpu_torch.ops import cuda_build  # noqa: E402
from mp2p_icp_tpu_torch.ops import nn_bruteforce as nnb  # noqa: E402

OUT = ROOT / "chiprun_out"
TUNE_DIR = cuda_build.BUILD_DIR / "tune"
SOURCES = ("knn_bruteforce.cu", "knn_batched.cu", "knn_streamed.cu")
# (label, B, Q, C, k): the timed shapes of the ported paths and of the odometry step
SHAPES = [("scan to scan", 1, 8192, 8192, 1), ("plane stage", 1, 8192, 8192, 8),
          ("odometry", 1, 6144, 16384, 1), ("odometry normals", 1, 2048, 22528, 8),
          ("seed's fit", 1, 6144, 6144, 8), ("fleet normals", 8, 2048, 22528, 8),
          ("1M-map crop", 1, 8192, 65536, 1), ("2M-map crop", 1, 8192, 262144, 1),
          ("2M-map crop k=8", 1, 8192, 262144, 8), ("batched", 8, 8192, 65536, 1),
          ("batched B=2", 2, 8192, 65536, 1)]
# (label, kernel, B, Q, C, k, valid queries, valid points per problem, the
# queries are the points): the rows of PERF.md section 6 that the counted
# sweep and the k > 1 form move, and the full k = 1 rows that must hold.
# None: every row valid (no counts). The padded rows' counts are those of
# their paths in chip_smoke.py's runs, on corridor points; a row
# whose label is in SMOKE_DATA takes chip_smoke.py phase 3's inputs.
ROWS = [
    ("kitti 2 m layer", "K1", 1, 131072, 131072, 1, [471], [478], False),
    ("kitti --mapping crop", "K1", 1, 131072, 131072, 1, [454], [5309], False),
    ("kitti -B 8", "K2", 8, 131072, 131072, 1, [449] * 7 + [451], [455] * 7 + [459], False),
    ("rawlog-filter normals", "K1", 1, 131072, 131072, 8, [3990], [3990], True),
    ("YAML normals", "K1", 1, 65536, 65536, 8, [2698], [2698], True),
    ("data x space rank", "K2", 4, 8192, 262144, 1, None, [142603, 151564, 147211, 149870],
     False),
    ("odometry normals", "K1", 1, 2048, 22528, 8, None, None, False),
    ("plane stage", "K1", 1, 8192, 8192, 8, None, None, False),
    ("seed's fit", "K1", 1, 6144, 6144, 8, None, None, True),
    ("fleet normals", "K2", 8, 2048, 22528, 8, None, None, False),
    ("2M-map crop k=8", "K3", 1, 8192, 262144, 8, None, None, False),
    ("scan to scan", "K1", 1, 8192, 8192, 1, None, None, False),
    ("odometry", "K1", 1, 6144, 16384, 1, None, None, False),
    ("1M-map crop", "K1", 1, 8192, 65536, 1, None, None, False),
    ("batched", "K2", 8, 8192, 65536, 1, None, None, False),
    ("B = 16 pairs", "K2", 16, 8192, 8192, 1, None, None, False),
    ("2M-map crop", "K3", 1, 8192, 262144, 1, None, None, False),
    ("2D demo k=5", "K1", 1, 1081, 1081, 5, None, None, False),
]
LOG = []


def say(line):
    print(line, flush=True)
    LOG.append(line)


def nvcc_start(tag, csrc, sources):
    """Start one nvcc per source of csrc; {stem: (library path, process)}."""
    TUNE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = TUNE_DIR / f"lib{pathlib.Path(src).stem}-{tag}.so"
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
               str(pathlib.Path(csrc) / src)]
        procs[pathlib.Path(src).stem] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def nvcc_finish(procs):
    """Wait for the processes; {stem: (CDLL, ptxas report, library path)}."""
    libs = {}
    for stem, (out, proc) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {out}:\n{stderr}")
        libs[stem] = (ctypes.CDLL(str(out)), stdout + stderr, out)
    return libs


def edited_csrc(settings, tag):
    """A copy of csrc with the named ``constexpr int`` constants of
    knn_sweep.cuh set to other values."""
    dst = TUNE_DIR / f"csrc-{tag}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC_DIR, dst)
    header = dst / "knn_sweep.cuh"
    text = header.read_text()
    for name, value in settings.items():
        text, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};", text)
        if n != 1:
            raise ValueError(f"knn_sweep.cuh has no 'constexpr int {name} = <number>;'")
    header.write_text(text)
    return dst


def say_ptxas(tag, report):
    """The ptxas lines of the k = 1 and k = 8 instantiations."""
    entry = None
    for line in report.splitlines():
        if "Compiling entry" in line or "Function properties" in line:
            entry = line.split("'")[1] if "'" in line else line.split()[-1]
        elif entry and ("Li1E" in entry or "Li8E" in entry) and (
                "registers" in line or "spill" in line):
            say(f"[ptxas] {tag} {entry}: {line.strip().removeprefix('ptxas info    : ')}")


class Problem:
    """Inputs and preallocated outputs of one shape on the card."""

    def __init__(self, B, k, q, p):
        self.B, self.Q, self.C, self.k = B, q.shape[-2], p.shape[-2], k
        self.q, self.p = q, p  # [B, Q, 3] or [Q, 3]; [B, C, 3] or [C, 3]
        self.out_d = torch.empty((B, self.Q, k), dtype=torch.float32, device=q.device)
        self.out_i = torch.empty((B, self.Q, k), dtype=torch.int32, device=q.device)
        self.part = {}

    def scratch(self, S):
        """(part_d, part_i) of S slices; the pool of thresholds is
        ``pool()``."""
        if S not in self.part:
            shape = (S, self.B * self.Q, self.k)
            self.part[S] = (torch.empty(shape, dtype=torch.float32, device=self.q.device),
                            torch.empty(shape, dtype=torch.int32, device=self.q.device))
        return self.part[S]

    def pool(self):
        """The k > 1 slices' pool of thresholds, [B * Q] at +inf: refilled
        before each launch, as the wrappers allocate it."""
        return torch.full((self.B * self.Q,), float("inf"), device=self.q.device)

    def strides(self):
        return (3 * self.Q if self.q.ndim == 3 else 0, 3 * self.C if self.p.ndim == 3 else 0)

    def tile(self, n_sm):
        """The register tile the wrappers take (``register_tile``)."""
        return nnb.register_tile(self.Q, self.C, n_sm, self.k, self.B)

    def chunks(self, r):
        return max(1, -(-self.Q // (32 * r))) * self.B


def ok(err):
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def run_form(fn, pr, r, form, counts=(None, None)):
    """Launch the batched entry point fn on pr with r queries per thread in
    the form (G, S, slice)."""
    qs, ps = pr.strides()
    pd, pi = pr.scratch(form.slices) if form.slices > 1 else (None, None)
    pt = pr.pool() if form.slices > 1 and pr.k > 1 else None
    ok(fn(pr.q.data_ptr(), pr.Q, qs, pr.p.data_ptr(), pr.C, ps, pr.B, pr.k, r, form.groups,
          form.slice_len, form.slices, *(None if c is None else c.data_ptr() for c in counts),
          *(None if x is None else x.data_ptr() for x in (pd, pi, pt)),
          pr.out_d.data_ptr(), pr.out_i.data_ptr(), torch.cuda.current_stream().cuda_stream))


def check_build(fn, tag, dev, n_sm):
    """A build against knn_plain_batched: ragged sizes, integer-grid points
    (ties everywhere), a misaligned batch stride, per-problem counts, every
    register tile of k > 1."""
    rng = np.random.RandomState(5)
    for B, Q, C, k in ((3, 777, 3001, 8), (1, 5000, 20011, 1), (2, 33, 5, 8), (3, 500, 2000, 5)):
        q, p = grid_points(rng, B, Q).to(dev), grid_points(rng, B, C).to(dev)
        pr = Problem(B, k, q, p)
        counts = (torch.tensor(rng.randint(0, Q + 1, B), dtype=torch.int32, device=dev),
                  torch.tensor(rng.randint(0, C + 1, B), dtype=torch.int32, device=dev))
        for cs, r in (((None, None), 8 if k == 1 else 1), (counts, 8 if k == 1 else 2),
                      (counts, nnb.queries_per_thread(k))):
            run_form(fn, pr, r, nnb.split_chunks(pr.chunks(r), C, n_sm), cs)
            d_ref, i_ref = nnb.knn_plain_batched(q, p, k, *cs)
            if not (torch.equal(pr.out_d, d_ref) and torch.equal(pr.out_i, i_ref)):
                raise RuntimeError(f"build {tag}: {B}x{Q}x{C} k={k} r={r} counts "
                                   f"{cs[0] is not None} differs from knn_plain_batched")
    say(f"[check] build {tag}: equal to knn_plain_batched bit for bit, ties and counts included")


def baseline_launchers(libs, n_sm):
    """{kernel: launch(problem)} for the entry points of a build whose sweep
    takes warps and slices but no counts, laid out by the split
    rule with that build's register tile: 8 queries a thread for k = 1, 1
    for k > 1."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    tail = [I, I, I, P, P, P, P, P]
    k1 = libs["knn_bruteforce"][0].mp2p_knn_sweep_f32
    k1.argtypes = [P, I, P, I, I] + tail
    k2 = libs["knn_batched"][0].mp2p_knn_sweep_batched_f32
    k2.argtypes = [P, I, L, P, I, L, I, I] + tail
    k3 = libs["knn_streamed"][0].mp2p_knn_sweep_streamed_f32
    k3.argtypes = [P, I, P, I, I] + tail
    for fn in (k1, k2, k3):
        fn.restype = ctypes.c_int

    def form(pr):
        return nnb.split_chunks(pr.chunks(8 if pr.k == 1 else 1), pr.C, n_sm)

    def split_args(pr, f):
        pd, pi = pr.scratch(f.slices) if f.slices > 1 else (None, None)
        return (f.groups, f.slice_len, f.slices, None if pd is None else pd.data_ptr(),
                None if pi is None else pi.data_ptr(), pr.out_d.data_ptr(),
                pr.out_i.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def run_one(fn):
        def run(pr):
            ok(fn(pr.q.data_ptr(), pr.Q, pr.p.data_ptr(), pr.C, pr.k,
                  *split_args(pr, form(pr))))
        return run

    def run_k2(pr):
        qs, ps = pr.strides()
        ok(k2(pr.q.data_ptr(), pr.Q, qs, pr.p.data_ptr(), pr.C, ps, pr.B, pr.k,
              *split_args(pr, form(pr))))

    return {"K1": run_one(k1), "K2": run_k2, "K3": run_one(k3)}


# ROWS whose inputs are chip_smoke.py phase 3's (so that their times
# compare with its rows of PERF.md section 6)
SMOKE_DATA = ("odometry normals", "plane stage", "seed's fit", "fleet normals",
              "2M-map crop k=8", "scan to scan", "odometry", "1M-map crop", "2M-map crop",
              "2D demo k=5")


def smoke_inputs(dev):
    """{row label: (queries, points)} built as chip_smoke.py's phase 3
    builds them: the bench street pair, the 2M-map case's scan and the
    first 2^18 points of the 16M corridor, the odometry and normals-fit
    cuts of them, the fleet's street scans and the 2D demo's planar pair."""
    import chip_smoke as cs
    from mp2p_icp_tpu_torch.eval.lidar_sim import make_street_sequence

    scene = cs.make_scene(np.random.RandomState(0))
    loc, glob = cs.street_pair(scene, 1, 2)
    q, p = loc["raw"].xyz.to(dev).contiguous(), glob["raw"].xyz.to(dev).contiguous()
    corridor = corridor_scene(np.random.RandomState(33), 1 << 24)
    scan_q = torch.from_numpy(local_window(corridor, 200.0, np.random.RandomState(34))).to(dev)
    map_p = torch.from_numpy(corridor[: 1 << 18]).to(dev)
    odo_q, odo_p = scan_q[:6144].contiguous(), map_p[: 1 << 14].contiguous()
    fit_q, fit_p = odo_q[:2048].contiguous(), torch.cat([odo_p, odo_q]).contiguous()
    _, _, scans_o = make_street_sequence(cs.ODO_FRAMES, dt=cs.ODO_DT)
    returns = [torch.from_numpy(sc["xyz"][sc["valid"]]) for sc in scans_o[:2 * cs.BATCH]]
    fleet_q = torch.stack([returns[2 * b][:6144] for b in range(cs.BATCH)]).to(dev)
    fleet_p = torch.stack([returns[2 * b + 1][: 1 << 14] for b in range(cs.BATCH)]).to(dev)
    fleet_fq = fleet_q[:, :2048].contiguous()
    fleet_fp = torch.cat([fleet_p, fleet_q], dim=1).contiguous()
    g2d, l2d, _ = cs.planar_pairs(n_pairs=1)[0]
    q2d = cs.sentinel_padded(cs.planar_layers(l2d)["2d_lidar"], 1.0e8).to(dev)
    p2d = cs.sentinel_padded(cs.planar_layers(g2d)["2d_lidar"], -1.0e8).to(dev)
    return {"odometry normals": (fit_q, fit_p), "plane stage": (q, p),
            "seed's fit": (odo_q, odo_q), "fleet normals": (fleet_fq, fleet_fp),
            "2M-map crop k=8": (scan_q, map_p), "scan to scan": (q, p),
            "odometry": (odo_q, odo_p), "1M-map crop": (scan_q, map_p[1 << 16:1 << 17]),
            "2M-map crop": (scan_q, map_p), "2D demo k=5": (q2d, p2d)}


def row_inputs(corridor, scans, maps, B, Q, C, kernel, n_q, n_p, same, smoke=None):
    """The inputs of one of ROWS on scans' device: queries, points (a
    normals fit's queries are its points) and the (queries, points) counts
    that the front ends pass (None: uncounted), the rows past each count
    set to the front ends' sentinels; ``smoke``: chip_smoke.py's inputs of
    the row, used as they are."""
    dev = scans.device
    if smoke is not None:
        return smoke[0], smoke[1], [None, None]
    src = corridor[: max(Q, C)]  # the queries of a normals fit are its points
    if B > 1:
        q = scans[:B, :Q] if Q <= 8192 else torch.from_numpy(np.stack([
            corridor[b * Q:(b + 1) * Q] for b in range(B)])).to(dev)
        p = torch.from_numpy(np.stack([corridor[b * C:(b + 1) * C] for b in range(B)])
                             ).to(dev) if C > 65536 else (
            maps[:B, :C] if B <= maps.shape[0] else scans.roll(1, 0)[:B, :C])
    else:
        q = torch.from_numpy(src[:Q]).to(dev) if same or Q > 8192 else scans[0, :Q]
        p = torch.from_numpy(src[:C]).to(dev) if C > 8192 or same else maps[1, :C]
    q, p = q.contiguous().clone(), p.contiguous().clone()
    counts = [None, None]
    for side, (x, n, far) in enumerate(((q, n_q, 1.0e8), (p, n_p, -1.0e8))):
        if n is not None:
            rows_ = x.view(-1, x.shape[-2], 3)
            for b, nb in enumerate(n):
                rows_[b, nb:] = far  # the padding: the front ends' sentinels
            counts[side] = torch.tensor(n, dtype=torch.int32, device=dev)
    if kernel != "K2":
        counts = [None if c is None else c[0] for c in counts]
    return q, p, counts


def report_sass(label, lib_path, mangled_part, save_as=None):
    """Count the inner loop of the first function whose mangled name
    contains mangled_part: the backward branch spanning at least 12 FMUL (4
    pairs) with the most FMUL per instruction."""
    cuobjdump = pathlib.Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    block = next((b for b in text.split("Function : ")[1:] if mangled_part in b.split()[0]), None)
    best = None
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;/]+);", block or "")]
    for addr, op in ins:
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
        if not m or int(m.group(1), 16) > addr:
            continue
        body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
        n_mul = sum(1 for o in body if re.search(r"\bFMUL\b", o))
        if n_mul >= 12 and (best is None or n_mul / len(body) > best[1] / len(best[0])):
            best = (body, n_mul)
    if best is None:
        say(f"[sass] {label}: no inner loop found in {mangled_part}")
        return None
    body, n_mul = best
    hist = collections.Counter(
        re.sub(r"^@!?U?P\d+\s+", "", o).split()[0].split(".")[0] for o in body)
    pairs = n_mul / 3
    say(f"[sass] {label} ({block.split()[0]}): inner loop {len(body)} instructions for "
        f"{pairs:g} pairs = {len(body) / pairs:.2f} issued per pair (9 of them the distance "
        f"and the compare); {dict(hist.most_common())}")
    if save_as:
        (OUT / save_as).write_text("Function : " + block)
    return {"loop_instructions": len(body), "pairs": pairs, "per_pair": len(body) / pairs,
            "histogram": dict(hist.most_common())}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--set", action="append", default=[], metavar="NAME=VALUE",
                    help="also build with this constant of knn_sweep.cuh replaced")
    ap.add_argument("--baseline-csrc", help="a csrc/ whose entry points take no counts "
                    "(e.g. the parent commit's), timed beside this build")
    ap.add_argument("--no-forms", action="store_true", help="skip the grid of launch forms")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    OUT.mkdir(exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    say(smi)
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    # ---- builds, all at once
    variants = {}  # tag -> (settings, nvcc processes): one edited build per --set
    for arg in args.set:
        settings = {n: int(v) for n, v in (a.split("=") for a in arg.split(","))}
        tag = "-".join(f"{n}{v}" for n, v in settings.items())
        variants[tag] = (settings, nvcc_start(tag, edited_csrc(settings, tag), SOURCES[1:2]))
    base_procs = nvcc_start("baseline", args.baseline_csrc, SOURCES) if args.baseline_csrc else None
    fn = nnb.K2.fn
    record = cuda_build.build_record("knn_batched")
    say_ptxas("as committed", record["log"])
    check_build(fn, "as committed", dev, n_sm)
    builds = {"as committed": (fn, record["path"])}
    for tag, (settings, procs) in variants.items():
        lib, report, path = nvcc_finish(procs)["knn_batched"]
        say_ptxas(tag, report)
        lib.mp2p_knn_sweep_batched_f32.argtypes = fn.argtypes
        lib.mp2p_knn_sweep_batched_f32.restype = ctypes.c_int
        check_build(lib.mp2p_knn_sweep_batched_f32, tag, dev, n_sm)
        builds[tag] = (lib.mp2p_knn_sweep_batched_f32, path)
    base = nvcc_finish(base_procs) if base_procs else None
    for stem, (_, report, _) in (base or {}).items():
        say_ptxas(f"baseline {stem}", report)

    # ---- problems
    corridor = corridor_scene(np.random.RandomState(33), 1 << 21)
    scans = torch.stack([torch.from_numpy(local_window(
        corridor, 60.0 + 40.0 * (b % 8), np.random.RandomState(100 + b)))
        for b in range(16)]).to(dev)
    maps = torch.stack([torch.from_numpy(corridor[(b << 16):((b + 1) << 16)])
                        for b in range(8)]).to(dev)
    big = torch.from_numpy(corridor[: 1 << 18]).to(dev)
    smoke = smoke_inputs(dev)
    problems = {}
    for label, B, Q, C, k in SHAPES:
        if label in smoke:
            q, p = smoke[label]
        elif B > 1:
            q, p = scans[:B, :Q].contiguous(), maps[:B, :C].contiguous()
        else:
            q = scans[0, :Q].contiguous()
            p = (big[:C] if C > 65536 else maps[1, :C]).contiguous()
        problems[label] = Problem(B, k, q, p)

    results = []

    def record_time(label, what, launch, pr, extra=None, bound=None):
        ms = statistics.median(graph_ms(launch))
        bnd = bound if bound is not None else bound_ms(pr.B, pr.Q, pr.C, pr.k)[0]
        results.append({"shape": label, "B": pr.B, "Q": pr.Q, "C": pr.C, "k": pr.k,
                        "what": what, "ms": ms, "bound_ms": bnd, "share_of_bound": bnd / ms,
                        **(extra or {})})
        say(f"[time] {label:22s} {pr.B}x{pr.Q}x{pr.C} k={pr.k} {what:40s} {ms:9.4f} ms  "
            f"bound {bnd:.6f} ms  share {bnd / ms:6.1%}  on {smi}")
        return ms

    def time_form(label, tag, r, form, rule):
        fn_, _ = builds[tag]
        pr = problems[label]
        warps = pr.chunks(r) * form.slices * form.groups / n_sm
        record_time(label, f"{tag}{' rule' if rule else ''} R={r} G={form.groups} "
                           f"S={form.slices} ({warps:.1f} w/SM)",
                    lambda: run_form(fn_, pr, r, form), pr,
                    {"build": tag, "rule": rule, "R": r, "groups": form.groups,
                     "S": form.slices, "slice": form.slice_len, "warps_per_sm": warps})

    for turn in range(2 if variants else 1):  # the builds in turns
        for label, *_ in SHAPES:
            pr = problems[label]
            r = pr.tile(n_sm)
            for tag in builds:
                time_form(label, tag, r, nnb.split_chunks(pr.chunks(r), pr.C, n_sm), True)
    for label, *_ in SHAPES if not args.no_forms else ():  # the grid of forms, as committed
        pr = problems[label]
        for r in (8,) if pr.k == 1 else nnb._TILES_KN:
            chunks = pr.chunks(r)
            forms = {nnb.split_form(chunks, pr.C, n_sm, g, w) for g in (1, 2, 4, 8, 16)
                     for w in (16, 32)} | {nnb.Split(16, 1, -(-pr.C // 64) * 64)}
            for form in sorted(forms):
                time_form(label, "as committed", r, form, False)

    # ---- the rows of PERF.md section 6, counted, against the baseline
    launchers = baseline_launchers(base, n_sm) if base else {}
    wrappers = {"K1": nnb.knn_sweep, "K2": nnb.knn_sweep_batched, "K3": nnb.knn_sweep_streamed}
    rows = []
    for label, kernel, B, Q, C, k, n_q, n_p, same in ROWS:
        q, p, counts = row_inputs(corridor, scans, maps, B, Q, C, kernel, n_q, n_p, same,
                                  smoke.get(label))
        pr = Problem(B, k, q, p)
        valid_q = sum(n_q) if n_q else B * Q
        valid_p = sum(n_p) if n_p else B * C
        pairs = sum(a * b for a, b in zip(n_q or [Q] * B, n_p or [C] * B))
        bnd = work_bound_ms(pairs, valid_q, valid_p, k)[0]
        call = [c if kernel != "K3" else None for c in counts]

        def run(kernel=kernel, q=q, p=p, k=k, call=call):
            if kernel == "K3":
                return wrappers[kernel](q, p, k)
            return wrappers[kernel](q, p, k, *call)

        d, i = run()
        plain = {"K1": nnb.knn_plain, "K2": nnb.knn_plain_batched,
                 "K3": nnb.knn_plain_streamed}[kernel]
        d_ref, i_ref = plain(q, p, k, *call) if kernel != "K3" else plain(q, p, k)
        same_result = torch.equal(d, d_ref) and torch.equal(i, i_ref)
        say(f"[check] {label}: {kernel} {B}x{Q}x{C} k={k} with counts "
            f"{n_q if n_q else 'none'} / {n_p if n_p else 'none'}: "
            f"{'equal to its plain version bit for bit' if same_result else 'DIFFERS'}")
        if not same_result:
            raise RuntimeError(f"{label}: the kernel differs from its plain version")
        del d_ref, i_ref
        times = {}
        for what in ("baseline", "this build", "this build", "baseline") if base \
                else ("this build",):
            fn_ = (lambda kernel=kernel, pr=pr: launchers[kernel](pr)) if what == "baseline" \
                else run
            times.setdefault(what, []).append(record_time(
                label, f"{kernel} {what}", fn_, pr, {"row": label, "kernel": kernel,
                                                      "build": what}, bound=bnd))
        row = {"row": label, "kernel": kernel, "shape": f"{B}x{Q}x{C}", "k": k,
               "valid_queries": valid_q, "valid_points": valid_p, "bound_ms": bnd,
               "ms": statistics.median(times["this build"])}
        if base:
            row["baseline_ms"] = statistics.median(times["baseline"])
            row["speedup"] = row["baseline_ms"] / row["ms"]
        rows.append(row)
        say(f"[row] {label}: {kernel} {B}x{Q}x{C} k={k}: {row['ms']:.4f} ms"
            + (f", baseline {row['baseline_ms']:.4f} ms ({row['speedup']:.2f}x)" if base else "")
            + f"; valid-row bound {bnd:.6f} ms, share {bnd / row['ms']:.1%} on {smi}")
        del pr, q, p
        torch.cuda.empty_cache()

    # ---- the inner loops
    sass = {}
    for tag, (_, path) in builds.items():
        first = tag == "as committed"
        for k in (1, 8):
            sass[f"{tag} k={k}"] = report_sass(
                f"{tag} k={k}", path, f"knn_sweep_kernelILi{k}E",
                f"knn_sweep_k{k}.sass" if first else None)
    if base:
        for k in (1, 8):
            sass[f"baseline K1 k={k}"] = report_sass(
                f"baseline K1 k={k}", base["knn_bruteforce"][2], f"kernelILi{k}E")

    own = [row for row in results if row.get("build") == "as committed"]
    for label, *_ in SHAPES:
        timed = [row for row in own if row["shape"] == label]
        best = min(timed, key=lambda row: row["ms"])
        rule = next(row for row in timed if row["rule"])
        say(f"[rule] {label}: {rule['what']} {rule['ms']:.4f} ms, {rule['ms'] / best['ms']:.3f} "
            f"of the best form timed ({best['what']} {best['ms']:.4f} ms)")
    (OUT / "knn_tune.json").write_text(json.dumps(
        {"card": smi, "results": results, "rows": rows, "sass": sass}, indent=1))
    (OUT / "knn_tune.log").write_text("\n".join(LOG) + "\n")
    print(json.dumps({"ok": True, "card": smi}))


if __name__ == "__main__":
    main()
