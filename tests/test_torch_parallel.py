"""The port's sharded paths on gloo ranks of the CPU, against the unsharded
port and the JAX package.

Ranks are processes started by ``parallel.launch.spawn_ranks`` (a
FileStore in a fresh directory; the data-parallel pair through the MP2P_*
variables and ``init_from_env``). Each spawn runs every case of its size
once (``parallel.ranks.sequence``), in a module fixture. The JAX side runs
on the virtual CPU devices of tests/conftest.py. Bands:

- the sharded kNN over 4 ranks equals one sweep of the whole map to the
  bit (d², global idx, neighbour xyz), on every rank; against the JAX
  package's sharded kNN over 4 devices: ``parity.py``'s kNN band;
- ``make_spatial_align`` over 4 ranks (the cases of tests/test_spatial.py)
  equals the unsharded align to the bit (pose, iterations, termination,
  pairings) where no shard's crop overflows; SE(3) error < 0.05 (the JAX
  test's gate);
- ``shard_global_layers`` equals the JAX package's, array for array;
- the data-parallel batch over 2 ranks equals the one-process batch to
  the bit (tests/test_multihost.py:55's twin);
- the mesh, ``init_from_env`` and the converters as the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

import mp2p_icp_tpu_torch
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.matchers import MatcherPointsDistanceThreshold as JDistance
from mp2p_icp_tpu.ops.nn_bruteforce import knn_bruteforce as jknn
from mp2p_icp_tpu.parallel.spatial import shard_global_layers as jshard
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.device import resolve
from mp2p_icp_tpu_torch.icp import ICP, ICPParameters
from mp2p_icp_tpu_torch.matchers import (
    MatcherAdaptive,
    MatcherPoint2Plane,
    MatcherPointsDistanceThreshold,
    MatcherPointsInlierRatio,
)
from mp2p_icp_tpu_torch.matchers.base import spatial_scale
from mp2p_icp_tpu_torch.ops import nn_bruteforce as nnb
from mp2p_icp_tpu_torch.parallel import multihost, ranks
from mp2p_icp_tpu_torch.parallel.batch import make_batched_align, stack_pytrees
from mp2p_icp_tpu_torch.parallel.launch import _rank_device, spawn_ranks
from mp2p_icp_tpu_torch.parallel.mesh import Mesh, MeshAxis, make_mesh
from mp2p_icp_tpu_torch.parallel.spatial import shard_global_layers
from mp2p_icp_tpu_torch.parity import knn_mismatch
from mp2p_icp_tpu_torch.solvers.gauss_newton import GNParams
from mp2p_icp_tpu_torch.solvers.solver import SolverGaussNewton, SolverHorn

SHARDS = 4
KS = (1, 2, 8)


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _np_layers(layers):
    return {k: convert.pointcloud_to_numpy(v) for k, v in layers.items()}


def _Rt(p):
    return p.R.numpy(), p.t.numpy()


# ------------------------------------------------------------------- inputs
def knn_problem():
    """tests/test_spatial.py's kNN case: 256 queries, 4096 points; the map
    is 4099 rows (padding on the last shard) with a few exact duplicates so
    that ties cross shard borders."""
    rng = np.random.RandomState(2)
    q = rng.uniform(-20, 20, (256, 3)).astype(np.float32)
    p = rng.uniform(-20, 20, (4099, 3)).astype(np.float32)
    p[1030:1040] = p[0:10]  # the same points on shards 0 and 1
    q[:10] = p[:10]
    return q, p


def scene_pair(seed, n_scene=4000, n_scan=1024):
    """tests/test_spatial.py's _scene_pair: a ground and two wall pairs."""
    rng = np.random.RandomState(seed)
    ground = np.stack([rng.uniform(-15, 15, n_scene // 2), rng.uniform(-15, 15, n_scene // 2),
                       np.zeros(n_scene // 2)], 1)
    wall_y = np.stack([rng.uniform(-15, 15, n_scene // 4), rng.choice([-5.0, 5.0], n_scene // 4),
                       rng.uniform(0, 3, n_scene // 4)], 1)
    wall_x = np.stack([rng.choice([-7.0, 7.0], n_scene // 4), rng.uniform(-15, 15, n_scene // 4),
                       rng.uniform(0, 3, n_scene // 4)], 1)
    scene = np.concatenate([ground, wall_y, wall_x]).astype(np.float32)
    gt = se3.from_xyz_ypr(0.4, -0.2, 0.05, 0.04, -0.01, 0.02)
    scan = scene[rng.choice(scene.shape[0], n_scan, replace=False)]
    local = se3.apply(se3.inverse(gt), torch.from_numpy(scan)).numpy()
    return ({"raw": PointCloud.from_numpy(local, capacity=n_scan)},
            {"raw": PointCloud.from_numpy(scene, capacity=4096)}, se3.identity(), gt)


def corridor_pair():
    """tests/test_spatial.py::test_sharded_crop_big_map: a 32k-point
    corridor with cross walls, a 512-point scan at x = 100."""
    rng = np.random.RandomState(11)
    n = 1 << 15
    t = rng.uniform(0, 200, n)
    kind = rng.randint(0, 4, n)
    y = np.where(kind == 0, -5.0, np.where(kind == 1, 5.0, rng.uniform(-5, 5, n)))
    z = np.where(kind < 2, rng.uniform(0, 3, n), np.where(kind == 2, 0.0, rng.uniform(0, 2.5, n)))
    x = np.where(kind == 3, np.round(t / 5.0) * 5.0, t)
    scene = np.stack([x, y, z], 1).astype(np.float32)
    gt = se3.from_xyz_ypr(100.4, -0.2, 0.05, 0.03, -0.01, 0.02)
    near = scene[np.abs(scene[:, 0] - 100.0) < 3.0]
    scan = near[rng.choice(near.shape[0], 512, replace=False)]
    local = se3.apply(se3.inverse(gt), torch.from_numpy(scan)).numpy()
    return ({"raw": PointCloud.from_numpy(local, capacity=512)},
            {"raw": PointCloud.from_numpy(scene, capacity=n)},
            se3.from_xyz_ypr(100.0, 0.0, 0.0, 0.0, 0.0, 0.0), gt)


def _horn_then_gn():
    return [SolverHorn(run_up_to_iteration=5),
            SolverGaussNewton(run_from_iteration=6, gn_params=GNParams(max_iterations=3))]


def _adaptive(**kw):
    return MatcherAdaptive(confidence_interval=0.75, first_to_second_distance_max=1.2,
                           absolute_max_search_distance=2.0, **kw)


# name -> (icp, params, problem): the cases of tests/test_spatial.py, and a
# point-to-plane refit
ALIGN_CASES = {
    "distance_threshold": (
        ICP(matchers=[MatcherPointsDistanceThreshold(threshold=1.0)], solvers=_horn_then_gn()),
        ICPParameters(max_iterations=25), lambda: scene_pair(4)),
    "adaptive_schedule": (
        ICP(matchers=[MatcherPointsDistanceThreshold(threshold=1.0, run_up_to_iteration=5),
                      _adaptive(run_from_iteration=6)], solvers=_horn_then_gn()),
        ICPParameters(max_iterations=20), lambda: scene_pair(4)),
    "inlier_ratio": (
        ICP(matchers=[MatcherPointsInlierRatio(inliers_ratio=0.7)], solvers=[SolverHorn()]),
        ICPParameters(max_iterations=20), lambda: scene_pair(7)),
    "multi_matcher": (
        ICP(matchers=[MatcherPointsDistanceThreshold(threshold=0.8), _adaptive()],
            solvers=[SolverHorn()]),
        ICPParameters(max_iterations=15), lambda: scene_pair(9)),
    "point2plane": (
        ICP(matchers=[MatcherPoint2Plane(distance_threshold=1.0, knn=8)],
            solvers=[SolverGaussNewton(gn_params=GNParams(max_iterations=3))]),
        ICPParameters(max_iterations=15), lambda: scene_pair(4)),
    "crop_big_map": (
        ICP(matchers=[MatcherPointsDistanceThreshold(threshold=1.0)], solvers=_horn_then_gn()),
        ICPParameters(max_iterations=20, crop_capacity=2048, crop_extra_margin=1.0),
        corridor_pair),
}


@pytest.fixture(scope="module")
def problems(_ask_for_the_cpu):
    return {name: case[2]() for name, case in ALIGN_CASES.items()}


@pytest.fixture(scope="module")
def four_ranks(problems):
    """Every 4-rank case in one spawn: the sharded kNN, then each align."""
    q, p = knn_problem()
    tasks = [(ranks.sharded_knn, (q, p, KS))]
    for name, (icp, params, _) in ALIGN_CASES.items():
        loc, glob, guess, _gt = problems[name]
        tasks.append((ranks.spatial_align, (icp, params, _np_layers(loc), _np_layers(glob),
                                            _Rt(guess))))
    out = spawn_ranks(ranks.sequence, SHARDS, "gloo", args=(tasks,), device="cpu")
    return {"knn": [r[0] for r in out],
            "align": {name: [r[1 + a] for r in out] for a, name in enumerate(ALIGN_CASES)}}


# -------------------------------------------------------------- sharded kNN
@pytest.mark.parametrize("k", KS)
def test_sharded_knn_equals_one_sweep(four_ranks, k):
    q, p = knn_problem()
    ones = torch.ones
    ref = nnb.knn_bruteforce(torch.from_numpy(q), ones(len(q), dtype=torch.bool),
                             torch.from_numpy(p), ones(len(p), dtype=torch.bool), k=k)
    for rank in four_ranks["knn"]:
        got = rank[k]
        np.testing.assert_array_equal(got["idx"], ref.idx.numpy())
        np.testing.assert_array_equal(got["dist_sq"], ref.dist_sq.numpy())
        ok = ref.valid.numpy()
        np.testing.assert_array_equal(got["xyz"][ok], p[ref.idx.numpy()[ok]])
    assert four_ranks["knn"][0]["shard_rows"] == -(-len(p) // SHARDS)


@pytest.mark.parametrize("k", KS)
def test_sharded_knn_matches_jax_sharded(four_ranks, k):
    q, p = knn_problem()
    Cs = -(-len(p) // SHARDS)
    pad = SHARDS * Cs - len(p)
    p_sh = np.concatenate([p, np.full((pad, 3), 1e8, np.float32)]).reshape(SHARDS, Cs, 3)
    pv_sh = (np.arange(SHARDS * Cs) < len(p)).reshape(SHARDS, Cs)
    qv = jnp.ones((len(q),), bool)
    mesh = JMesh(np.array(jax.devices()[:SHARDS]), ("space",))

    def body(q_, p1, pv1):
        return jknn(q_, qv, p1[0], pv1[0], k=k, spatial_axis="space")

    want = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(), P("space"), P("space")),
                                 out_specs=P(), check_vma=False))(q, p_sh, pv_sh)
    got = four_ranks["knn"][0][k]
    bad = knn_mismatch(q, p, got["idx"], got["idx"] >= 0, np.asarray(want.idx),
                       np.asarray(want.dist_sq), np.asarray(want.valid))
    assert not bad.any(), f"{bad.sum()} entries outside the kNN band"


def test_shard_global_layers_matches_jax():
    rng = np.random.RandomState(0)
    xyz = rng.rand(1000, 3).astype(np.float32)
    inten = rng.rand(1000).astype(np.float32)
    sh = shard_global_layers({"raw": PointCloud.from_numpy(xyz, capacity=2051,
                                                           intensity=inten)}, 8)["raw"]
    want = jshard({"raw": JPointCloud.from_numpy(xyz, capacity=2051, intensity=inten)}, 8)["raw"]
    assert sh.xyz.shape == (8, 257, 3) and int(sh.count.sum()) == 1000
    for f in ("xyz", "count", "intensity"):
        np.testing.assert_array_equal(getattr(sh, f).numpy(), np.asarray(getattr(want, f)))
    assert convert.sharded_layers_from_jax({"raw": want})["raw"].xyz.shape == (8, 257, 3)


# ------------------------------------------------------------ spatial align
@pytest.mark.parametrize("case", list(ALIGN_CASES))
def test_spatial_align_equals_unsharded(four_ranks, problems, case):
    icp, params, _ = ALIGN_CASES[case]
    loc, glob, guess, gt = problems[case]
    ref = icp.align(loc, glob, guess, params)
    crop = params.crop_capacity if glob["raw"].capacity // SHARDS > params.crop_capacity else None
    for rank in four_ranks["align"][case]:
        assert crop is None or rank["in_box"]["raw"] <= crop  # no crop strides: exact
        np.testing.assert_array_equal(rank["pose"][0], ref.optimal_tf.R.numpy())
        np.testing.assert_array_equal(rank["pose"][1], ref.optimal_tf.t.numpy())
        assert rank["iterations"] == ref.n_iterations
        assert rank["termination"] == ref.termination_reason.name
        assert rank["pairings"] == int(ref.final_pairings.size())
        assert rank["quality"] == float(ref.quality)
    R, t = (torch.from_numpy(a) for a in four_ranks["align"][case][0]["pose"])
    assert float(se3.error_log_norm(gt, se3.Pose(R, t))) < 0.05


def test_spatial_align_refuses_matchers_without_the_axis():
    from mp2p_icp_tpu_torch.matchers import MatcherPoint2Line
    from mp2p_icp_tpu_torch.parallel.spatial import make_spatial_align

    mesh = Mesh(data=MeshAxis("data", 1, 0), space=MeshAxis("space", 1, 0))
    with pytest.raises(NotImplementedError, match="spatial_axis"):
        make_spatial_align(ICP(matchers=[MatcherPoint2Line()], solvers=[SolverHorn()]),
                           ICPParameters(), mesh)


# ----------------------------------------------------------- data parallel
def batch_problems(B=4):
    """TestBroadcastGlobals' pattern: B scans of one shared 4096-point map."""
    rng = np.random.RandomState(11)
    scene = rng.uniform(-40, 40, (4096, 3)).astype(np.float32)
    locs, guesses = [], []
    for b in range(B):
        gt = se3.from_xyz_ypr(0.3 + 0.1 * b, -0.2, 0.1, 0.05, -0.03, 0.02 * b)
        scan = scene[rng.choice(4096, 512, replace=False)]
        locs.append({"raw": PointCloud.from_numpy(
            se3.apply(se3.inverse(gt), torch.from_numpy(scan)).numpy(), capacity=512)})
        guesses.append(se3.identity())
    return locs, {"raw": PointCloud.from_numpy(scene, capacity=4096)}, guesses


def test_data_parallel_batch_equals_one_process(_ask_for_the_cpu):
    """Two processes started by init_from_env from the MP2P_* variables,
    each aligning its half of the batch against the shared map:
    fetch_replicated gives every rank the whole batch, equal to the one
    process's batched call to the bit."""
    icp = ICP(matchers=[MatcherPointsDistanceThreshold(threshold=1.0)], solvers=[SolverHorn()])
    params = ICPParameters(max_iterations=8)
    locs, glob, guesses = batch_problems()
    out = spawn_ranks(ranks.data_parallel_batch, 2, "gloo", init="env", device="cpu", args=(
        icp, params, [_np_layers(x) for x in locs], _np_layers(glob), [_Rt(g) for g in guesses]))
    ref = make_batched_align(icp, params, broadcast_globals=True)(
        stack_pytrees(locs), glob, stack_pytrees(guesses))
    for rank in out:
        assert rank["rows"] == 2
        np.testing.assert_array_equal(rank["R"], ref.optimal_tf.R.numpy())
        np.testing.assert_array_equal(rank["t"], ref.optimal_tf.t.numpy())
        np.testing.assert_array_equal(rank["iterations"], ref.n_iterations.numpy())
        np.testing.assert_array_equal(rank["termination"], ref.termination_reason.numpy())


# --------------------------------------------------- mesh, start-up, convert
def test_rank_devices_follow_the_default():
    # spawn_ranks(device=None) takes the caller's default_device(): the card,
    # one for each rank, unless the caller asked for another device
    mp2p_icp_tpu_torch.set_default_device(None)
    try:
        assert _rank_device(resolve(None), 2) == torch.device("cuda", 2)
    finally:
        mp2p_icp_tpu_torch.set_default_device("cpu")
    assert _rank_device(resolve(None), 2) == torch.device("cpu")
    assert _rank_device(torch.device("cuda:0"), 3) == torch.device("cuda", 0)


def test_one_process_mesh_and_multihost(monkeypatch):
    monkeypatch.delenv("MP2P_COORDINATOR", raising=False)
    monkeypatch.delenv("MP2P_NUM_PROCESSES", raising=False)
    assert multihost.init_from_env("gloo") is False
    mesh = multihost.make_global_mesh(n_space=1)
    assert mesh.axis_names == ("data", "space") and mesh.shape == {"data": 1, "space": 1}
    with pytest.raises(ValueError):
        make_mesh(n_data=2, n_space=1)  # one rank
    x = {"a": torch.arange(16.0).reshape(8, 2), "s": 3}
    g = multihost.host_local_batch(mesh, x)
    assert g["s"] == 3
    np.testing.assert_array_equal(multihost.fetch_replicated(g["a"], mesh), x["a"].numpy())


def test_convert_carries_spatial_axis():
    axis = MeshAxis("space", 4, 2)
    mesh = Mesh(data=MeshAxis("data", 1, 0), space=axis)
    jm = dataclasses.replace(JDistance(threshold=0.7), spatial_axis="space", spatial_num_shards=4)
    tm = convert.matcher_from_config(*convert.config_of(jm), mesh=mesh)
    assert tm.spatial_axis is axis and spatial_scale(tm) == 4 and tm.threshold == 0.7
    with pytest.raises(ValueError, match="mesh"):
        convert.matcher_from_config(*convert.config_of(jm))
    with pytest.raises(ValueError, match="spatial_num_shards=2"):
        convert.matcher_from_config(
            *convert.config_of(dataclasses.replace(jm, spatial_num_shards=2)), mesh=mesh)
