"""Traffic kind ``localization``: one robot's scans aligned against a
prebuilt map by ``ICP.align`` in a closed loop.

Set-up draws the map and ``scans`` scans at evenly spaced positions from
``first_x_m`` to ``last_x_m`` along it. Scan j's guess error has the
components mag_c * (k + 0.5) / scans for a k of a per-component
permutation, with random signs: every seed asks for the same set of error
sizes, in another order. Requests take the scans in turn, one align each,
back to back until the window's seconds are up; a request is done when its
pose is on the host. A traced run's window closes after request
max(b, check_requests) - 1.

Traffic keys: scans, first_x_m, last_x_m, trace_requests [a, b] (requests
a ... b-1 traced), check_requests (scans whose aligns are held against the
reference, drawn from the seed)."""

from __future__ import annotations

import time

import torch

from benchmark import programs, reference, scenes, se3
from benchmark.checks import align_numbers
from benchmark.harness import Window


def _tenths(xs):
    n = max(len(xs) // 10, 1)
    return [xs[i:i + n] for i in range(0, len(xs), n)]


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, log):
        self.cfg, self.traffic, self.seed, self.log = cfg, traffic, seed, log
        host, dev_gen = scenes.generators(seed, device)
        mp, sc = cfg["map"], cfg["scan"]
        self.map_xyz = scenes.corridor_scene(mp["points"], mp["length_m"], dev_gen)
        n = traffic["scans"]
        mags = torch.tensor(sc["guess_error"], dtype=torch.float64)
        frac = (torch.arange(n, dtype=torch.float64) + 0.5) / n
        perm = torch.stack([torch.randperm(n, generator=host) for _ in range(6)], 1)
        sign = torch.where(torch.rand((n, 6), generator=host) < 0.5, -1.0, 1.0)
        self.errors = (frac[perm] * sign * mags).tolist()
        self.scans, self.guesses, self.truths = [], [], []
        for j in range(n):
            cx = traffic["first_x_m"] + (traffic["last_x_m"] - traffic["first_x_m"]) * j / max(n - 1, 1)
            local, guess, truth = scenes.sensor_scan(self.map_xyz, cx, self.errors[j], sc["points"],
                                                     sc["radius_m"], sc["noise_m"], sc["height_m"],
                                                     dev_gen)
            self.scans.append(local)
            self.guesses.append(guess)
            self.truths.append(truth)
        self.icp, self.params = programs.map_icp(cfg)
        self.map_layers = {"map": programs.points_cloud(self.map_xyz)}
        self.locals = [{"raw": programs.points_cloud(s)} for s in self.scans]
        self.guess_poses = [programs.pose(R, t, device) for R, t in self.guesses]
        self.answers = {}

    def align(self, j: int):
        """(R, t, iterations, reason, final pairings): the pose on the host,
        the pairings left on the device until the window has closed."""
        res = self.icp.align(self.locals[j], self.map_layers, self.guess_poses[j], self.params)
        return (res.optimal_tf.R.cpu(), res.optimal_tf.t.cpu(), int(res.n_iterations),
                res.termination_reason.name.lower(), res.final_pairings)

    def warm(self):
        self.align(0)

    def window(self, seconds: float, tracer=None) -> Window:
        a, b = self.traffic["trace_requests"] if tracer is not None else (-1, -1)
        last = max(b, self.traffic["check_requests"])
        n = len(self.scans)
        requests, its, errs = [], [], []
        start = time.perf_counter()
        deadline = start + seconds
        done, r = start, 0
        while r < last if tracer is not None else time.perf_counter() < deadline:
            if r == a:
                tracer.begin()
            j = r % n
            t0 = time.perf_counter()
            ans = self.align(j)
            done = time.perf_counter()
            if r == b - 1:
                tracer.end()
                tracer.note(scans=b - a, iterations=sum(its[a:]) + ans[2])
            requests.append((t0, done, 1))
            its.append(ans[2])
            self.answers.setdefault(j, ans)
            errs.append(float(se3.gaps((ans[0].double(), ans[1].double()), self.truths[j])[0]))
            r += 1
        ms = [(e - s) * 1e3 / i for (s, e, _), i in zip(requests, its)]
        self.log(f"[scan] {len(requests)} aligns; ICP iterations mean {sum(its) / len(its):.3f}, "
                 f"max {max(its)}; translation error against the truth max {max(errs):.5f} m; ms "
                 f"per ICP iteration by tenth of the window "
                 f"{' '.join(f'{sum(c) / len(c):.2f}' for c in _tenths(ms))}")
        return Window(start, done, requests)

    def checked_scans(self) -> list:
        """The scans held against the reference: drawn from the seed among
        those the window aligned (all scans where no window ran)."""
        g = torch.Generator().manual_seed(self.seed)
        done = sorted(self.answers) or list(range(len(self.scans)))
        pick = torch.randperm(len(done), generator=g)[:self.traffic["check_requests"]]
        return sorted(done[i] for i in pick.tolist())

    def release(self):
        self.answers = {j: a[:4] + (int(a[4].size()),) for j, a in self.answers.items()}
        self.map_layers = self.locals = self.icp = None

    def program(self) -> list:
        return [self.answers[j] for j in self.checked_scans()]

    def reference(self, prec) -> list:
        out = []
        for j in self.checked_scans():
            pose, its, reason, inside, pairs = reference.align_to_map(
                self.map_xyz, self.scans[j], self.guesses[j], self.cfg["icp"], prec)
            out.append((pose[0].double().cpu(), pose[1].double().cpu(), its, reason, pairs))
            self.log(f"[scan] reference ({prec.dtype}, tf32 {prec.tf32}) scan {j}: {its} "
                     f"iterations, {reason}, {pairs} pairs, crop box rows {inside}")
        return out

    @staticmethod
    def compare(prog: list, ref: list) -> dict:
        return align_numbers(prog, ref)
