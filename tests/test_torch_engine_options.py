"""The engine options of the port against the JAX package on the CPU: the
per-iteration hook, the optimal scale, the per-iteration records, and the
debug log files (mirrors tests/test_hooks_scale_debug.py:47-200).

Bands: poses and recorded rows 1e-5 where the iterations agree (the port's
solvers sum in float64, the JAX package's in float32); scale relative 1e-4;
pair counts and decimated pairings row for row except ties (<= 1%); a log
file array for array, exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.metric_map import MetricMap as JMetricMap
from mp2p_icp_tpu.core.pairings import Pairings as JPairings
from mp2p_icp_tpu.core.pairings import PairsPt2Pt as JPairsPt2Pt
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.icp import ICP as JICP
from mp2p_icp_tpu.icp import ICPParameters as JICPParameters
from mp2p_icp_tpu.icp import ICPResults as JICPResults
from mp2p_icp_tpu.io import icplog as jicplog
from mp2p_icp_tpu.matchers import MatcherPointsDistanceThreshold as JDistance
from mp2p_icp_tpu.solvers.horn import horn_scale as jhorn_scale
from mp2p_icp_tpu.solvers.solver import SolverHorn as JHorn
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.metric_map import MetricMap
from mp2p_icp_tpu_torch.core.pairings import Pairings, PairsPt2Pt
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters, IterTermReason
from mp2p_icp_tpu_torch.io import debug_dump, icplog
from mp2p_icp_tpu_torch.matchers import MatcherPointsDistanceThreshold
from mp2p_icp_tpu_torch.solvers.horn import horn_scale
from mp2p_icp_tpu_torch.solvers.solver import SolverHorn


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


GT = (0.4, -0.25, 0.15, 0.06, -0.04, 0.03)


def _problem(n=512, seed=0, scale=1.0):
    """numpy (global, local) of tests/test_hooks_scale_debug.py's problem."""
    rng = np.random.RandomState(seed)
    xyz = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    gt = se3.from_xyz_ypr(*GT)
    local = se3.apply(se3.inverse(gt), torch.from_numpy(xyz)).numpy() / scale
    return xyz, local.astype(np.float32)


def _maps(g, loc):
    """((local, global) of the port, (local, global) of the JAX package)."""
    return (({"raw": PointCloud.from_numpy(loc)}, {"raw": PointCloud.from_numpy(g)}),
            ({"raw": JPointCloud.from_numpy(loc)}, {"raw": JPointCloud.from_numpy(g)}))


def _icps(threshold=1.5, **horn):
    return (ICP(matchers=[MatcherPointsDistanceThreshold(threshold=threshold)],
                solvers=[SolverHorn(**horn)]),
            JICP(matchers=[JDistance(threshold=threshold)], solvers=[JHorn(**horn)]))


def _pose_gap(res_t, res_j):
    return float(se3.error_log_norm(
        convert.pose_from_numpy(np.asarray(res_j.optimal_tf.R), np.asarray(res_j.optimal_tf.t)),
        res_t.optimal_tf))


# ------------------------------------------------------------ iteration hook
def test_iteration_hook_stop_request():
    """The hook sees the kept pose as tensors ([3, 3], [3]) and stops the
    align after iteration 1 in both packages."""
    (lt, gt), (lj, gj) = _maps(*_problem())
    seen = []

    def hook(iteration, R, t, n_pairs):
        seen.append((tuple(R.shape), tuple(t.shape)))
        return (iteration >= 1) & (n_pairs > 0)

    ticp, jicp = _icps()
    res = ticp.align(lt, gt, se3.identity(), ICPParameters(max_iterations=25, iteration_hook=hook))
    jres = jicp.align(lj, gj, jse3.identity(),
                      JICPParameters(max_iterations=25, iteration_hook=hook))
    assert res.termination_reason == IterTermReason.HOOK_REQUEST == int(jres.termination_reason)
    assert res.n_iterations == int(jres.n_iterations) == 2
    assert seen and all(s == ((3, 3), (3,)) for s in seen)
    assert _pose_gap(res, jres) < 1e-5


def test_iteration_hook_passive_matches_no_hook():
    """A hook that never stops leaves the align equal to the bit, and both
    packages agree."""
    (lt, gt), (lj, gj) = _maps(*_problem(seed=3))
    ticp, jicp = _icps()
    res0 = ticp.align(lt, gt, se3.identity(), ICPParameters(max_iterations=25))
    res1 = ticp.align(lt, gt, se3.identity(), ICPParameters(
        max_iterations=25, iteration_hook=lambda it, R, t, n: torch.tensor(False)))
    assert res1.n_iterations == res0.n_iterations
    assert res1.termination_reason == res0.termination_reason
    assert torch.equal(res1.optimal_tf.R, res0.optimal_tf.R)
    assert torch.equal(res1.optimal_tf.t, res0.optimal_tf.t)
    jres = jicp.align(lj, gj, jse3.identity(), JICPParameters(
        max_iterations=25, iteration_hook=lambda it, R, t, n: jnp.asarray(False)))
    assert abs(res1.n_iterations - int(jres.n_iterations)) <= 1
    assert _pose_gap(res1, jres) < 1e-5
    assert float(se3.error_log_norm(se3.from_xyz_ypr(*GT), res1.optimal_tf)) < 0.05


def test_debug_print_iteration_progress(capsys):
    """One line per iteration on the host; the align is unchanged."""
    (lt, gt), _ = _maps(*_problem(seed=3))
    ticp = _icps()[0]
    res = ticp.align(lt, gt, se3.identity(), ICPParameters(
        max_iterations=25, debug_print_iteration_progress=True))
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == res.n_iterations and lines[0].startswith("[ICP] iteration 0:")
    assert lines[-1].endswith(res.termination_reason.name)
    ref = ticp.align(lt, gt, se3.identity(), ICPParameters(max_iterations=25))
    assert torch.equal(res.optimal_tf.t, ref.optimal_tf.t)


# ------------------------------------------------------------- horn scale
def test_horn_scale_unit_recovers_known_scale():
    rng = np.random.RandomState(7)
    n, cap = 200, 256
    local = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    s_true = 1.37
    R = se3.from_xyz_ypr(0, 0, 0, 0.3, -0.2, 0.1).R.numpy()
    globl = (s_true * local @ R.T + np.array([1.0, -2.0, 0.5], np.float32)).astype(np.float32)
    pad = np.zeros((cap - n, 3), np.float32)
    fields = dict(local=np.concatenate([local, pad]), globl=np.concatenate([globl, pad]),
                  weight=np.concatenate([np.ones(n), np.zeros(cap - n)]).astype(np.float32),
                  local_idx=np.arange(cap, dtype=np.int32),
                  global_idx=np.arange(cap, dtype=np.int32))
    pt = dataclasses.replace(Pairings.empty(pt2pt_cap=cap), pt2pt=PairsPt2Pt(
        **{k: torch.from_numpy(v) for k, v in fields.items()}))
    pj = dataclasses.replace(JPairings.empty(pt2pt_cap=cap), pt2pt=JPairsPt2Pt(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    s_t, s_j = float(horn_scale(pt)), float(jhorn_scale(pj))
    assert abs(s_t - s_true) < 1e-3
    assert s_t == pytest.approx(s_j, rel=1e-5)
    assert float(horn_scale(Pairings.empty(pt2pt_cap=4))) == 1.0


def test_icp_fills_optimal_scale():
    """The local cloud shrunk by 1/1.05: the rigid align converges and
    optimal_scale reports the scale, as the JAX package's does."""
    s_true = 1.05
    (lt, gt), (lj, gj) = _maps(*_problem(n=1024, seed=5, scale=s_true))
    ticp, jicp = _icps(threshold=2.5, estimate_scale=True)
    res = ticp.align(lt, gt, se3.identity(), ICPParameters(max_iterations=30))
    jres = jicp.align(lj, gj, jse3.identity(), JICPParameters(max_iterations=30))
    assert abs(float(res.optimal_scale) - s_true) < 0.02
    assert float(res.optimal_scale) == pytest.approx(float(jres.optimal_scale), rel=1e-4)
    res0 = _icps()[0].align(lt, gt, se3.identity(), ICPParameters(max_iterations=5))
    assert float(res0.optimal_scale) == 1.0


# ------------------------------------------------------------ records
@pytest.mark.parametrize("capacity", [64, 4096])
def test_recorded_rows_match_jax(capacity):
    """iteration_poses / iteration_pair_counts / iteration_pairings have
    max_iterations rows in both packages; the tail repeats the final state;
    rows agree at 1e-5, pair counts and decimated pairings except ties.
    Capacity 64 decimates every block, 4096 keeps them whole."""
    (lt, gt), (lj, gj) = _maps(*_problem(seed=4))
    ticp, jicp = _icps()
    jparams = JICPParameters(max_iterations=20, record_iterations=True, record_pairings=True,
                             record_pairings_capacity=capacity)
    params = convert.params_from_config(dataclasses.asdict(jparams))
    assert params == ICPParameters(max_iterations=20, record_iterations=True,
                                   record_pairings=True, record_pairings_capacity=capacity)
    res = ticp.align(lt, gt, se3.identity(), params)
    jres = jicp.align(lj, gj, jse3.identity(), jparams)
    n = res.n_iterations
    assert n == int(jres.n_iterations) and n < 20
    assert res.iteration_poses.t.shape == (20, 3) and res.iteration_pair_counts.shape == (20,)
    assert torch.equal(res.iteration_poses.t[-1], res.optimal_tf.t)
    assert torch.equal(res.iteration_poses.R[n:], res.optimal_tf.R.expand(20 - n, 3, 3))
    np.testing.assert_allclose(res.iteration_poses.t.numpy(), np.asarray(jres.iteration_poses.t),
                               atol=1e-5)
    np.testing.assert_allclose(res.iteration_poses.R.numpy(), np.asarray(jres.iteration_poses.R),
                               atol=1e-5)
    ct, cj = res.iteration_pair_counts.numpy(), np.asarray(jres.iteration_pair_counts)
    assert np.all(np.abs(ct - cj) <= 0.01 * cj)
    rec_t, rec_j = res.iteration_pairings.pt2pt, jres.iteration_pairings.pt2pt
    assert rec_t.weight.shape == np.asarray(rec_j.weight).shape
    li_t, li_j = rec_t.local_idx.numpy(), np.asarray(rec_j.local_idx)
    assert (li_t != li_j).mean() <= 0.01
    assert torch.equal(res.iteration_pairings.pt2pt.weight[-1], res.final_pairings.decimated(
        capacity).pt2pt.weight)


def test_decimated_pairings_match_jax():
    """Pairings.decimated block for block: an even stride over the valid
    rows, compacted, exactly as the JAX package's."""
    rng = np.random.RandomState(9)
    cap = 1000
    w = (rng.rand(cap) > 0.3).astype(np.float32)
    fields = dict(local=rng.rand(cap, 3).astype(np.float32),
                  globl=rng.rand(cap, 3).astype(np.float32), weight=w,
                  local_idx=np.where(w > 0, np.arange(cap), -1).astype(np.int32),
                  global_idx=np.where(w > 0, rng.randint(0, 5000, cap), -1).astype(np.int32))
    pt = dataclasses.replace(Pairings.empty(pt2pt_cap=cap), pt2pt=PairsPt2Pt(
        **{k: torch.from_numpy(v) for k, v in fields.items()}))
    pj = dataclasses.replace(JPairings.empty(pt2pt_cap=cap), pt2pt=JPairsPt2Pt(
        **{k: jnp.asarray(v) for k, v in fields.items()}))
    for capacity in (7, 100, 699, 5000):
        dt, dj = pt.decimated(capacity), pj.decimated(capacity)
        for name in ("pt2pt", "ln2ln"):
            for f in dataclasses.fields(getattr(dt, name)):
                np.testing.assert_array_equal(getattr(getattr(dt, name), f.name).numpy(),
                                              np.asarray(getattr(getattr(dj, name), f.name)))


# ------------------------------------------------------------ debug output
def test_generate_debug_files(tmp_path):
    """$-template names, the unique-id counter, file and iteration
    decimation, as tests/test_hooks_scale_debug.py:130-164 shows them."""
    debug_dump.reset_unique_id_counter()
    (lt, gt), _ = _maps(*_problem(seed=1))
    fmt = str(tmp_path / "logs" / "icp-run-$UNIQUE_ID-local-$LOCAL_ID$LOCAL_LABEL-"
              "global-$GLOBAL_ID$GLOBAL_LABEL.icplog.npz")
    params = ICPParameters(max_iterations=12, generate_debug_files=True,
                           save_iteration_details=True, decimation_iteration_details=3,
                           decimation_debug_files=2, debug_file_name_format=fmt)
    icp = _icps()[0]
    for _ in range(4):
        res = icp.align(lt, gt, se3.identity(), params)
    files = sorted(p.name for p in (tmp_path / "logs").iterdir())
    assert files == ["icp-run-00000-local-00000-global-00000.icplog.npz",
                     "icp-run-00002-local-00000-global-00000.icplog.npz"]
    log = icplog.load_log(tmp_path / "logs" / files[0])
    assert log["meta"]["n_iterations"] == res.n_iterations
    assert log["iterations"]["poses"].t.shape[0] == 4  # ceil(12 / 3)
    assert "pairings" in log["iterations"]
    assert log["local"]["raw"].xyz.shape[0] > 0
    # the JAX package reads the port's file
    jlog = jicplog.load_log(tmp_path / "logs" / files[0])
    np.testing.assert_array_equal(np.asarray(jlog["result"].t), log["result"].t.numpy())


def test_debug_functor_and_labels(tmp_path):
    debug_dump.reset_unique_id_counter()
    (lt, gt), _ = _maps(*_problem(seed=2))
    g_mm = MetricMap(layers=dict(gt), id=7, label="gmap")
    l_mm = MetricMap(layers=dict(lt), id=3, label="scan")

    def shrink(mm):
        out = dict(mm.layers)
        out["raw"] = PointCloud.from_numpy(out["raw"].to_numpy()[:16], capacity=16)
        return dataclasses.replace(mm, layers=out)

    params = ICPParameters(
        max_iterations=6, generate_debug_files=True,
        debug_file_name_format=str(tmp_path / "d-$UNIQUE_ID-$LOCAL_ID$LOCAL_LABEL-"
                                   "$GLOBAL_ID$GLOBAL_LABEL.icplog.npz"),
        functor_before_logging_local=shrink, functor_before_logging_global=shrink)
    _icps()[0].align(l_mm, g_mm, se3.identity(), params)
    path = tmp_path / "d-00000-00003scan-00007gmap.icplog.npz"
    assert path.exists()
    log = icplog.load_log(path)
    assert log["local"]["raw"].xyz.shape[0] == log["global"]["raw"].xyz.shape[0] == 16
    assert debug_dump.format_debug_filename("$UNIQUE_ID-$GLOBAL_ID", 12, {}, g_mm) == "00012-00007"


def test_log_written_by_port_equals_jax_log(tmp_path):
    """A record written by the port equals, array for array, the one the
    JAX package writes from the same results converted to its types."""
    (lt, gt), _ = _maps(*_problem(seed=6))
    res = _icps()[0].align(lt, gt, se3.identity(), ICPParameters(
        max_iterations=8, record_iterations=True, record_pairings=True,
        record_pairings_capacity=32))
    icplog.save_log(tmp_path / "port.icplog.npz", MetricMap(layers=lt), gt, se3.identity(), res)

    j = jax_tree
    jres = JICPResults(
        optimal_tf=jse3.Pose(*j(res.optimal_tf)), optimal_scale=j(res.optimal_scale),
        n_iterations=jnp.asarray(res.n_iterations), termination_reason=jnp.asarray(
            int(res.termination_reason)), quality=j(res.quality),
        final_pairings=j_pairings(res.final_pairings), covariance=j(res.covariance),
        iteration_poses=jse3.Pose(*j(res.iteration_poses)),
        iteration_pair_counts=j(res.iteration_pair_counts),
        iteration_pairings=j_pairings(res.iteration_pairings))
    jl = JMetricMap(layers={"raw": JPointCloud(xyz=j(lt["raw"].xyz), count=j(lt["raw"].count))})
    jg = {"raw": JPointCloud(xyz=j(gt["raw"].xyz), count=j(gt["raw"].count))}
    jicplog.save_log(tmp_path / "jax.icplog.npz", jl, jg, jse3.identity(), jres)
    with np.load(tmp_path / "port.icplog.npz") as a, np.load(tmp_path / "jax.icplog.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def jax_tree(tree):
    """A tensor, or a tuple of tensors, as jnp arrays."""
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy())
    return tuple(jnp.asarray(x.numpy()) for x in tree)


def j_pairings(p):
    """The JAX package's Pairings with the arrays of the port's."""
    from mp2p_icp_tpu.core import pairings as jp

    blocks = {name: getattr(jp, type(getattr(p, name)).__name__)(**{
        f.name: jnp.asarray(getattr(getattr(p, name), f.name).numpy())
        for f in dataclasses.fields(getattr(p, name))})
        for name in ("pt2pt", "pt2ln", "pt2pl", "ln2ln", "pl2pl")}
    return JPairings(potential_pairings=jnp.asarray(p.potential_pairings.numpy()), **blocks)
