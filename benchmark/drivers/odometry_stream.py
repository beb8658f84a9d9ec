"""Traffic kind ``odometry_stream``: one vehicle's scans through
``OdometryMapper.run`` in a closed loop.

The drive of ``pass_frames`` frames is rendered once in set-up. A pass is
one ``run`` over it from a fresh map seeded by its first frame, with the
pose of each frame read on the host before the next frame is handed in
(``progress_every``), as a vehicle's controller reads it. Passes run back
to back until the window's seconds are up; the window closes when the pass
in flight ends. A request is one frame after the first of its pass: it is
handed in when ``run`` takes it from the frame sequence and done when the
next is taken (the last: when ``run`` returns).

Every pass gets the same frames; the last pass's answers are held against
the reference's run over them. Set-up warms with a pass over the first
``warm_frames`` frames: the capacities are fixed, so those frames launch
every kernel at every shape that a whole pass does. A traced run's window
is its first pass.

Traffic keys: pass_frames, progress_every, warm_frames, trace_steps [a, b]
(the traced frames a ... b-1 of the first pass)."""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
import torch

from benchmark import programs, reference, scenes
from benchmark.checks import odometry_numbers, worst
from benchmark.harness import Window


class FrameClock(Sequence):
    """The frames of a pass, each take of a frame index timed."""

    def __init__(self, frames):
        self.frames = frames
        self.taken = {}

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        self.taken.setdefault(i, time.perf_counter())
        return self.frames[i]

    def requests(self, done: float):
        """[(handed in, done, scans)] of frames 1 ... n-1."""
        n = len(self.frames)
        ends = [self.taken[i + 1] for i in range(1, n - 1)] + [done]
        return [(self.taken[i], ends[i - 1], 1) for i in range(1, n)]


def step_hook(mapper, a: int, b: int, tracer):
    """Opens the traced window before step a of the next drive and closes it
    before step b (steps are counted from 1, as the frames)."""
    step = mapper._step
    seen = [0]

    def hooked(*args, **kwargs):
        seen[0] += 1
        if seen[0] == a:
            tracer.begin()
        elif seen[0] == b:
            tracer.end()
        return step(*args, **kwargs)

    mapper._step = hooked

    def unhook():
        del mapper._step

    return unhook


def program_pass(res, map_pc, dropped) -> dict:
    """A pass's answers on the host: poses, iterations, the map."""
    n = int(map_pc.count)
    return {"poses": res["poses"], "iterations": np.asarray(res["iterations"]),
            "map": (map_pc.xyz[:n].detach().cpu(), map_pc.normals[:n].detach().cpu()),
            "dropped": int(dropped)}


class Driver:
    """Scans per request: 1."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, log):
        self.cfg, self.traffic, self.seed, self.log = cfg, traffic, seed, log
        n = traffic["pass_frames"]
        if n > cfg["sequence_frames"]:
            raise ValueError(f"a pass of {n} frames exceeds the configured drive")
        self.gt, self.twists, scans = scenes.street_drive(cfg, n, seed, device)
        self.raw = [scenes.compact_scan(s, cfg["sensor"]["raw_capacity"]) for s in scans]
        del scans
        self.frames = [{"raw": programs.frame_cloud(r)} for r in self.raw]
        self.mapper = programs.odometry_mapper(cfg)
        self.pose0 = programs.pose(torch.from_numpy(self.gt[0, :3, :3]),
                                   torch.from_numpy(self.gt[0, :3, 3]), device)
        self.kept = None

    def one_pass(self, frames):
        return self.mapper.run(frames, twists=self.twists[:len(frames)],
                               dt=self.cfg["sensor"]["period_s"], initial_pose=self.pose0,
                               progress_every=self.traffic["progress_every"])

    def warm(self):
        self.one_pass(self.frames[:self.traffic["warm_frames"]])

    def window(self, seconds: float, tracer=None) -> Window:
        requests, iterations, seconds_of = [], [], []
        unhook = None
        if tracer is not None:
            unhook = step_hook(self.mapper, *self.traffic["trace_steps"], tracer)
        start = time.perf_counter()
        deadline = start + seconds
        done = start
        while not iterations if tracer is not None else time.perf_counter() < deadline:
            clock = FrameClock(self.frames)
            t0 = time.perf_counter()
            res = self.one_pass(clock)
            done = time.perf_counter()
            seconds_of.append(done - t0)
            if unhook is not None:
                unhook()
                unhook = None
                a, b = self.traffic["trace_steps"]
                tracer.note(scans=b - a, iterations=int(np.sum(res["iterations"][a - 1:b - 1])))
            requests += clock.requests(done)
            iterations.append(np.asarray(res["iterations"]))
            st = res["map_state"]
            self.kept = program_pass(res, st.pc, st.n_dropped)
        its = np.concatenate(iterations)
        self.log(f"[stream] {len(iterations)} passes, {len(requests)} frames, ICP iterations "
                 f"per frame: mean {its.mean():.3f}, max {its.max()}; map points "
                 f"{self.kept['map'][0].shape[0]}, dropped {self.kept['dropped']}; seconds per "
                 f"pass {' '.join(f'{x:.3f}' for x in seconds_of)}")
        return Window(start, done, requests)

    def release(self):
        self.frames = None
        self.mapper = None

    def reference(self, prec) -> list:
        pose0 = (torch.from_numpy(self.gt[0, :3, :3]), torch.from_numpy(self.gt[0, :3, 3]))
        ref = reference.odometry(self.raw, self.twists, pose0, self.cfg, prec)
        self.log(f"[stream] reference ({prec.dtype}, tf32 {prec.tf32}): decimation voxels max "
                 f"{max(ref['voxels'])}, crop box rows max {max(ref['crop_inside'])}, map points "
                 f"{ref['map'][0].shape[0]}, dropped {ref['dropped']}, ICP iterations "
                 f"{int(np.sum(ref['iterations']))}")
        return [ref]

    def program(self) -> list:
        return [self.kept]

    @staticmethod
    def compare(prog: list, ref: list) -> dict:
        return worst([odometry_numbers(p, r) for p, r in zip(prog, ref)])
