"""Traffic kind ``odometry_fleet``: several vehicles' streams through
``BatchedOdometryMapper.run``, one fleet frame serving every stream.

The drive is rendered once in set-up; stream b is its frames
offset * b ... offset * b + pass_frames - 1, with its own map seeded from
its first frame and its own pose and twists (as bench_torch.py cuts the
fleet). A pass is one ``run`` of all streams; passes run back to back until
the window's seconds are up, and the window closes when the pass in flight
ends. The poses of a pass reach the host when ``run`` returns, so a pass is
one request of streams * (pass_frames - 1) scans. Set-up warms with a
pass over each stream's first ``warm_frames`` frames (the capacities are
fixed, so they launch every kernel at every shape a whole pass does). A
traced run's window is its first pass.

Traffic keys: streams, pass_frames, stream_offset_frames, warm_frames,
trace_steps [a, b] (fleet frames a ... b-1 of the first pass),
check_streams (streams of the last pass held against the reference, drawn
from the seed)."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import programs, reference, scenes
from benchmark.checks import odometry_numbers, worst
from benchmark.drivers.odometry_stream import step_hook
from benchmark.harness import Window


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, log):
        from mp2p_icp_tpu_torch.odometry import BatchedOdometryMapper

        self.cfg, self.traffic, self.seed, self.log = cfg, traffic, seed, log
        B, n, off = traffic["streams"], traffic["pass_frames"], traffic["stream_offset_frames"]
        total = off * (B - 1) + n
        if total > cfg["sequence_frames"]:
            raise ValueError(f"the fleet needs {total} frames, more than the configured drive")
        self.gt, self.twists, scans = scenes.street_drive(cfg, total, seed, device)
        self.raw = [scenes.compact_scan(s, cfg["sensor"]["raw_capacity"]) for s in scans]
        del scans
        frames = [{"raw": programs.frame_cloud(r)} for r in self.raw]
        self.offsets = [off * b for b in range(B)]
        self.streams = [frames[o:o + n] for o in self.offsets]
        self.stream_twists = [self.twists[o:o + n] for o in self.offsets]
        self.poses0 = [programs.pose(torch.from_numpy(self.gt[o, :3, :3]),
                                     torch.from_numpy(self.gt[o, :3, 3]), device)
                       for o in self.offsets]
        self.mapper = programs.odometry_mapper(cfg)
        self.fleet = BatchedOdometryMapper(self.mapper)
        self.kept = None

    def one_pass(self, n: int):
        """One ``run`` over each stream's first n frames."""
        return self.fleet.run([s[:n] for s in self.streams],
                              twists=[t[:n] for t in self.stream_twists],
                              initial_poses=self.poses0, dt=self.cfg["sensor"]["period_s"])

    def warm(self):
        self.one_pass(self.traffic["warm_frames"])

    def window(self, seconds: float, tracer=None) -> Window:
        B, n = self.traffic["streams"], self.traffic["pass_frames"]
        requests, iterations = [], []
        unhook = None
        if tracer is not None:
            unhook = step_hook(self.mapper, *self.traffic["trace_steps"], tracer)
        start = time.perf_counter()
        deadline = start + seconds
        done = start
        while not requests if tracer is not None else time.perf_counter() < deadline:
            t0 = time.perf_counter()
            res = self.one_pass(n)
            done = time.perf_counter()
            if unhook is not None:
                unhook()
                unhook = None
                a, b = self.traffic["trace_steps"]
                tracer.note(scans=(b - a) * B,
                            iterations=int(np.sum(res["iterations"][:, a - 1:b - 1])))
            requests.append((t0, done, B * (n - 1)))
            iterations.append(np.asarray(res["iterations"]))
            self.kept = res
        its = np.stack(iterations)
        self.log(f"[fleet] {len(requests)} passes of {B} x {n - 1} scans, ICP iterations per "
                 f"scan: mean {its.mean():.3f}, fleet frame (slowest stream) mean "
                 f"{its.max(axis=1).mean():.3f}; map points {res['map_counts'][:, -1].tolist()}; "
                 f"seconds per pass {' '.join(f'{e - s:.3f}' for s, e, _ in requests)}")
        return Window(start, done, requests)

    def checked_streams(self) -> list:
        g = torch.Generator().manual_seed(self.seed)
        B = self.traffic["streams"]
        return sorted(torch.randperm(B, generator=g)[:self.traffic["check_streams"]].tolist())

    def release(self):
        res = self.kept
        maps = res["maps"]
        self.kept = []
        for b in self.checked_streams():
            n = int(maps.count[b])
            self.kept.append({"poses": res["poses"][b], "iterations": res["iterations"][b],
                              "map": (maps.xyz[b, :n].detach().cpu(),
                                      maps.normals[b, :n].detach().cpu())})
        self.streams = self.fleet = self.mapper = None

    def program(self) -> list:
        return self.kept

    def reference(self, prec) -> list:
        out = []
        n = self.traffic["pass_frames"]
        for b in self.checked_streams():
            o = self.offsets[b]
            pose0 = (torch.from_numpy(self.gt[o, :3, :3]), torch.from_numpy(self.gt[o, :3, 3]))
            out.append(reference.odometry(self.raw[o:o + n], self.twists[o:o + n], pose0,
                                          self.cfg, prec))
        self.log(f"[fleet] reference ({prec.dtype}, tf32 {prec.tf32}) of streams "
                 f"{self.checked_streams()}: map points {[r['map'][0].shape[0] for r in out]}, "
                 f"dropped {[r['dropped'] for r in out]}")
        return out

    @staticmethod
    def compare(prog: list, ref: list) -> dict:
        return worst([odometry_numbers(p, r) for p, r in zip(prog, ref)])
