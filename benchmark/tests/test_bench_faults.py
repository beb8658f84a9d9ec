"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (harness.run: inputs, program, window,
reference, comparison) without the run's look for a card, once with the
program sound and once for each fault that the cell can have:

- a step that returns its state unchanged: the map update returns the map
  as it was (odometry), the ICP step keeps the pose it was given
  (localization);
- half of the batch left out and the mean taken over the rest: the ICP sees
  half of each scan's points; in the fleet, half of the streams run and
  their answers stand for the others;
- an answer altered where it is produced: 0.1 m added to the pose that the
  ICP returns.

There is no exchange between chips in these one-chip cells. On the CPU the
cells run at the tests' tiny size (tests/tiny/) against the tiny limits
(tests/tiny/limits/); the ``cuda`` cases run the full cells on the card
against their own limits.

    python -m pytest benchmark/tests -q
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark.tests.test_bench_harness import tiny_tree  # noqa: E402

SEED = 12


def _map_unchanged(mp):
    from mp2p_icp_tpu_torch import odometry

    mp.setattr(odometry.OdometryMapper, "_insert",
               lambda self, map_state, src_world, near_map, valid=None: map_state)


def _pose_unchanged(mp):
    from mp2p_icp_tpu_torch.icp import ICP

    step = ICP._step

    def kept(self, params, prior, iteration, m_active, s_active, finished, g_layers, l_layers,
             pose, prev_pose, gidx_maps):
        out = step(self, params, prior, iteration, m_active, s_active, finished, g_layers,
                   l_layers, pose, prev_pose, gidx_maps)
        return (out[0], pose) + tuple(out[2:])
    mp.setattr(ICP, "_step", kept)


def _half_points(mp):
    from mp2p_icp_tpu_torch.icp import ICP

    core = ICP._align_core

    def half(self, params, g_layers, l_layers, guess, prior, gidx_maps=None):
        halved = {k: dataclasses.replace(v, count=v.count // 2) for k, v in l_layers.items()}
        return core(self, params, g_layers, halved, guess, prior, gidx_maps)
    mp.setattr(ICP, "_align_core", half)


def _half_streams(mp):
    from mp2p_icp_tpu_torch import odometry

    run = odometry.BatchedOdometryMapper.run

    def half(self, streams, twists=None, initial_poses=None, dt=None):
        h = len(streams) // 2
        res = run(self, streams[:h], twists=twists[:h], initial_poses=initial_poses[:h], dt=dt)
        maps = res["maps"]
        twice = dataclasses.replace(maps, **{f.name: None if getattr(maps, f.name) is None else
                                             torch.cat([getattr(maps, f.name)] * 2)
                                             for f in dataclasses.fields(maps)})
        return {**res, "poses": torch.cat([torch.as_tensor(res["poses"])] * 2).numpy(),
                "iterations": torch.cat([torch.as_tensor(res["iterations"])] * 2).numpy(),
                "maps": twice}
    mp.setattr(odometry.BatchedOdometryMapper, "run", half)


def _pose_altered(mp):
    from mp2p_icp_tpu_torch import odometry
    from mp2p_icp_tpu_torch.icp import ICP
    from mp2p_icp_tpu_torch.parallel import batch

    def altered(res):
        tf = res.optimal_tf
        return res._replace(optimal_tf=type(tf)(tf.R, tf.t + 0.1))

    core = ICP._align_core
    mp.setattr(ICP, "_align_core", lambda *a, **k: altered(core(*a, **k)))
    batched = batch._align_batched
    mp.setattr(odometry, "_align_batched", lambda *a, **k: altered(batched(*a, **k)))


FAULTS = {
    "odom_kitti64.stream": {"state unchanged": _map_unchanged, "half the points": _half_points,
                            "answer altered": _pose_altered},
    "loc_corridor16m.scan": {"state unchanged": _pose_unchanged, "half the points": _half_points,
                             "answer altered": _pose_altered},
    "odom_kitti64.fleet8": {"state unchanged": _map_unchanged, "half the streams": _half_streams,
                            "answer altered": _pose_altered},
}
CASES = [(cell, None) for cell in FAULTS] + [(cell, f) for cell in FAULTS for f in FAULTS[cell]]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_step_is_not_correct(root, monkeypatch, cell, fault):
    import mp2p_icp_tpu_torch

    monkeypatch.setattr(mp2p_icp_tpu_torch.device, "_requested", torch.device("cpu"))
    if fault is not None:
        FAULTS[cell][fault](monkeypatch)
    line = harness.run(cell, SEED, 0.01, False, "cpu", root=root)
    assert line["correct"] is (fault is None), line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_step_is_not_correct_on_the_card(monkeypatch, cell, fault):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the full cell runs the CUDA kNN kernels")
    if fault is not None:
        FAULTS[cell][fault](monkeypatch)
    line = harness.run(cell, SEED, 1.0, False, "cuda")
    assert line["correct"] is (fault is None), line["checks"]
