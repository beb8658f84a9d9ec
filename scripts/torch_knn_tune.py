#!/usr/bin/env python3
"""Time the launch forms of the port's kNN sweep on one NVIDIA GPU and count
the instructions of its inner loop.

    python3 scripts/torch_knn_tune.py [--set NAME=VALUE ...] [--baseline-csrc DIR]

What it does (every line names the card and its power limit):

1. builds ``csrc/knn_batched.cu`` (the entry point that takes every launch
   parameter: problems, warps per block, slices) and prints the ptxas
   report of its k = 1 and k = 8 kernels (registers, spills, shared memory);
2. at the shapes the ported paths and the odometry step use, times the form
   that the wrappers' rule (``nn_bruteforce.split_chunks``) chooses and a
   grid of forms (``nn_bruteforce.split_form``): G warps per block x a
   target of warps per SM, and the one-launch form (16 warps, no slices).
   A time is the device time per launch in a CUDA graph
   (``chip_smoke.graph_ms``), the median of its replays, beside the bound
   (``chip_smoke.bound_ms``);
3. with ``--set`` (e.g. ``--set kTile=256 --set kStages=3``): also builds a
   copy of the sources with those constants of ``knn_sweep.cuh`` replaced,
   holds it against ``knn_plain_batched`` on a tie-heavy case and times the
   rule's form with it, in turns with the build of the sources as they are;
4. with ``--baseline-csrc DIR`` (the csrc of the version before the sweep
   was redesigned, whose entry points take no warps or slices for K1 and
   K2): times those kernels at the same shapes in the same call, before and
   after the new ones;
5. disassembles each build (``cuobjdump -sass``), finds the inner loop of
   the k = 1 and k = 8 sweep kernels (the shortest backward branch that
   spans at least 12 FMUL) and counts its instructions per pair.

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

from chip_smoke import bound_ms, corridor_scene, graph_ms, grid_points, local_window  # noqa: E402
from mp2p_icp_tpu_torch.ops import cuda_build  # noqa: E402
from mp2p_icp_tpu_torch.ops import nn_bruteforce as nnb  # noqa: E402

OUT = ROOT / "chiprun_out"
TUNE_DIR = cuda_build.BUILD_DIR / "tune"
SOURCES = ("knn_bruteforce.cu", "knn_batched.cu", "knn_streamed.cu")
# (label, B, Q, C, k): the timed shapes of the ported paths and of the odometry step
SHAPES = [("scan to scan", 1, 8192, 8192, 1), ("scan to scan k=8", 1, 8192, 8192, 8),
          ("odometry", 1, 6144, 16384, 1), ("odometry normals", 1, 2048, 16384, 8),
          ("1M-map crop", 1, 8192, 65536, 1), ("2M-map crop", 1, 8192, 262144, 1),
          ("2M-map crop k=8", 1, 8192, 262144, 8), ("batched", 8, 8192, 65536, 1),
          ("batched B=2", 2, 8192, 65536, 1)]
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


def edited_csrc(settings):
    """A copy of csrc with the named ``constexpr int`` constants of
    knn_sweep.cuh set to other values."""
    dst = TUNE_DIR / "csrc"
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
        if S not in self.part:
            shape = (S, self.B * self.Q, self.k)
            self.part[S] = (torch.empty(shape, dtype=torch.float32, device=self.q.device),
                            torch.empty(shape, dtype=torch.int32, device=self.q.device))
        return self.part[S]

    def strides(self):
        return (3 * self.Q if self.q.ndim == 3 else 0, 3 * self.C if self.p.ndim == 3 else 0)

    def chunks(self, r):
        return max(1, -(-self.Q // (32 * r))) * self.B


def ok(err):
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def run_form(fn, pr, form):
    """Launch the batched entry point fn on pr in the form (G, S, slice)."""
    qs, ps = pr.strides()
    pd, pi = pr.scratch(form.slices) if form.slices > 1 else (None, None)
    ok(fn(pr.q.data_ptr(), pr.Q, qs, pr.p.data_ptr(), pr.C, ps, pr.B, pr.k, form.groups,
          form.slice_len, form.slices, None if pd is None else pd.data_ptr(),
          None if pi is None else pi.data_ptr(), pr.out_d.data_ptr(), pr.out_i.data_ptr(),
          torch.cuda.current_stream().cuda_stream))


def check_build(fn, tag, dev, r, n_sm):
    """A build against knn_plain_batched: ragged sizes, integer-grid points
    (ties everywhere), a misaligned batch stride."""
    rng = np.random.RandomState(5)
    for B, Q, C, k in ((3, 777, 3001, 8), (1, 5000, 20011, 1), (2, 33, 5, 8)):
        q, p = grid_points(rng, B, Q).to(dev), grid_points(rng, B, C).to(dev)
        pr = Problem(B, k, q, p)
        run_form(fn, pr, nnb.split_chunks(pr.chunks(r[k == 1]), C, n_sm))
        d_ref, i_ref = nnb.knn_plain_batched(q, p, k)
        if not (torch.equal(pr.out_d, d_ref) and torch.equal(pr.out_i, i_ref)):
            raise RuntimeError(f"build {tag}: {B}x{Q}x{C} k={k} differs from knn_plain_batched")
    say(f"[check] build {tag}: equal to knn_plain_batched bit for bit, ties included")


def baseline_launchers(libs, n_sm):
    """{kernel: launch(problem)} for the entry points of the version before
    the redesign: one thread per query, 64 queries per block; its streamed
    kernel in slices of 512-point tiles, 16 blocks per SM."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    k1 = libs["knn_bruteforce"][0].mp2p_knn_sweep_f32
    k1.argtypes = [P, I, P, I, I, P, P, P]
    k2 = libs["knn_batched"][0].mp2p_knn_sweep_batched_f32
    k2.argtypes = [P, I, L, P, I, L, I, I, P, P, P]
    k3 = libs["knn_streamed"][0].mp2p_knn_sweep_streamed_f32
    k3.argtypes = [P, I, P, I, I, I, I, P, P, P, P, P]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run_k1(pr):
        ok(k1(pr.q.data_ptr(), pr.Q, pr.p.data_ptr(), pr.C, pr.k, pr.out_d.data_ptr(),
              pr.out_i.data_ptr(), stream()))

    def run_k2(pr):
        qs, ps = pr.strides()
        ok(k2(pr.q.data_ptr(), pr.Q, qs, pr.p.data_ptr(), pr.C, ps, pr.B, pr.k,
              pr.out_d.data_ptr(), pr.out_i.data_ptr(), stream()))

    def run_k3(pr):
        S = max(1, min(-(-16 * n_sm // max(1, -(-pr.Q // 64))), -(-pr.C // 2048), 65535))
        slice_len = max(512, -(-(-(-pr.C // S)) // 512) * 512)
        S = max(1, -(-pr.C // slice_len))
        pd, pi = pr.scratch(S)
        ok(k3(pr.q.data_ptr(), pr.Q, pr.p.data_ptr(), pr.C, pr.k, slice_len, S, pd.data_ptr(),
              pi.data_ptr(), pr.out_d.data_ptr(), pr.out_i.data_ptr(), stream()))

    return {"K1": run_k1, "K2": run_k2, "K3": run_k3}


def report_sass(label, lib_path, mangled_part, save_as=None):
    """Count the inner loop of the first function whose mangled name
    contains mangled_part: the shortest backward branch spanning at least
    12 FMUL (4 pairs)."""
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
        if n_mul >= 12 and (best is None or len(body) < len(best[0])):
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
    ap.add_argument("--baseline-csrc", help="csrc of the version before the redesign")
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
    settings = {name: int(value) for name, value in (s.split("=") for s in args.set)}
    set_tag = "-".join(f"{n}{v}" for n, v in settings.items())
    set_procs = nvcc_start(set_tag, edited_csrc(settings), SOURCES[1:2]) if settings else None
    base_procs = nvcc_start("baseline", args.baseline_csrc, SOURCES) if args.baseline_csrc else None
    fn = nnb.load_batched_kernel()
    record = cuda_build.build_record("knn_batched")
    say_ptxas("as committed", record["log"])
    r_now = (nnb.queries_per_thread(8), nnb.queries_per_thread(1))  # indexed by k == 1
    builds = {"as committed": (fn, r_now, record["path"])}
    if set_procs:
        lib, report, path = nvcc_finish(set_procs)["knn_batched"]
        say_ptxas(set_tag, report)
        lib.mp2p_knn_sweep_batched_f32.argtypes = fn.argtypes
        r_set = (settings.get("kQueriesKn", r_now[0]), settings.get("kQueriesK1", r_now[1]))
        check_build(lib.mp2p_knn_sweep_batched_f32, set_tag, dev, r_set, n_sm)
        builds[set_tag] = (lib.mp2p_knn_sweep_batched_f32, r_set, path)
    base = nvcc_finish(base_procs) if base_procs else None
    for stem, (_, report, _) in (base or {}).items():
        say_ptxas(f"baseline {stem}", report)

    # ---- problems
    corridor = corridor_scene(np.random.RandomState(33), 1 << 21)
    scans = torch.stack([torch.from_numpy(local_window(
        corridor, 60.0 + 40.0 * b, np.random.RandomState(100 + b))) for b in range(8)]).to(dev)
    maps = torch.stack([torch.from_numpy(corridor[(b << 16):((b + 1) << 16)])
                        for b in range(8)]).to(dev)
    big = torch.from_numpy(corridor[: 1 << 18]).to(dev)
    problems = {}
    for label, B, Q, C, k in SHAPES:
        if B > 1:
            q, p = scans[:B, :Q].contiguous(), maps[:B, :C].contiguous()
        else:
            q = scans[0, :Q].contiguous()
            p = (big[:C] if C > 65536 else maps[1, :C]).contiguous()
        problems[label] = Problem(B, k, q, p)

    results = []

    def record_time(label, what, launch, extra=None):
        pr = problems[label]
        ms = statistics.median(graph_ms(launch))
        bnd = bound_ms(pr.B, pr.Q, pr.C, pr.k)[0]
        results.append({"shape": label, "B": pr.B, "Q": pr.Q, "C": pr.C, "k": pr.k,
                        "what": what, "ms": ms, "bound_ms": bnd, "share_of_bound": bnd / ms,
                        **(extra or {})})
        say(f"[time] {label:18s} {pr.B}x{pr.Q}x{pr.C} k={pr.k} {what:40s} {ms:9.4f} ms  "
            f"bound {bnd:.4f} ms  share {bnd / ms:6.1%}  on {smi}")

    def time_baseline(turn):
        launchers = baseline_launchers(base, n_sm) if base else {}
        for label, B, Q, C, k in SHAPES if base else ():
            pr = problems[label]
            for name in ["K2"] if B > 1 else (["K1", "K3"] if C > nnb.STREAM_BLOCK else ["K1"]):
                record_time(label, f"baseline {name} ({turn})", lambda: launchers[name](pr))

    def time_form(label, tag, form, rule):
        fn_, r, _ = builds[tag]
        pr = problems[label]
        warps = pr.chunks(r[pr.k == 1]) * form.slices * form.groups / n_sm
        record_time(label, f"{tag}{' rule' if rule else ''} G={form.groups} S={form.slices} "
                           f"({warps:.1f} w/SM)", lambda: run_form(fn_, pr, form),
                    {"build": tag, "rule": rule, "groups": form.groups, "S": form.slices,
                     "slice": form.slice_len, "warps_per_sm": warps})

    time_baseline("before")
    for turn in range(2 if settings else 1):  # the two builds in turns
        for label, *_ in SHAPES:
            for tag, (_, r, _) in builds.items():
                pr = problems[label]
                time_form(label, tag, nnb.split_chunks(pr.chunks(r[pr.k == 1]), pr.C, n_sm), True)
    for label, *_ in SHAPES:  # the grid of forms, for the sources as they are
        pr = problems[label]
        chunks = pr.chunks(r_now[pr.k == 1])
        forms = {nnb.split_form(chunks, pr.C, n_sm, g, w) for g in (1, 2, 4, 8, 16)
                 for w in (16, 32)} | {nnb.Split(16, 1, -(-pr.C // 64) * 64)}
        for form in sorted(forms):
            time_form(label, "as committed", form, False)
    time_baseline("after")

    # ---- the inner loops
    sass = {}
    for tag, (_, _, path) in builds.items():
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
        rows = [row for row in own if row["shape"] == label]
        best = min(rows, key=lambda row: row["ms"])
        rule = next(row for row in rows if row["rule"])
        say(f"[rule] {label}: {rule['what']} {rule['ms']:.4f} ms, {rule['ms'] / best['ms']:.3f} "
            f"of the best form timed ({best['what']} {best['ms']:.4f} ms)")
    (OUT / "knn_tune.json").write_text(json.dumps(
        {"card": smi, "results": results, "sass": sass}, indent=1))
    (OUT / "knn_tune.log").write_text("\n".join(LOG) + "\n")
    print(json.dumps({"ok": True, "card": smi}))


if __name__ == "__main__":
    main()
