"""The batched align over a data x space mesh, on gloo ranks of the CPU,
against the one-process batch and the JAX package's data x space placement;
the vmap rule of the sharded kNN's all_gather; and the multi-rank dry run
``scripts/torch_multichip_dryrun.py``.

One spawn of 4 ranks (a 2 x 2 mesh: ``data`` rows of 2 ``space`` ranks)
runs every case (``parallel.ranks.sequence``), in a module fixture; every
spawn runs under a timeout (a rank that waits on a collective another skips
hangs, it does not fail). The JAX side runs on the 8 virtual CPU devices of
tests/conftest.py, through ``scripts/torch_parallel_reference.jax_data_space_batch``.
Bands:

- the vmapped sharded kNN (k = 1 and 8; each problem's map or one shared
  map; with and without a payload and a per-query radius) equals a loop of
  unbatched sharded calls and one batched sweep of the whole maps, d² and
  idx to the bit, with one all_gather per call for the whole batch;
- the batch over the mesh (the dry run's per-problem maps; a shared
  corridor map that each shard crops without overflow; per-problem maps
  with a quality evaluator that has its own matcher) equals the
  one-process batch to the bit (R, t, iterations, termination, quality) on
  every rank, one all_gather per matcher call;
- against JAX's ``make_batched_align`` placed with P("data", "space") on a
  4 x 2 mesh: the align band (same termination, iterations +-1, pose gap
  < 5e-3);
- the dry run with 2 and 4 ranks on the CPU exits 0 and ends with the JAX
  dry run's line and the backend.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.icp import ICPParameters
from mp2p_icp_tpu_torch.matchers import MatcherPointsDistanceThreshold
from mp2p_icp_tpu_torch.ops import nn_bruteforce as nnb
from mp2p_icp_tpu_torch.parallel import ranks
from mp2p_icp_tpu_torch.parallel.launch import spawn_ranks
from mp2p_icp_tpu_torch.parallel.mesh import MeshAxis
from mp2p_icp_tpu_torch.parallel.spatial import own_shard, shard_global_layers, spatial_icp
from mp2p_icp_tpu_torch.quality import QualityPairedRatio

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import torch_multichip_dryrun as dryrun  # noqa: E402

RANKS, N_SPACE = 4, 2
KS = (1, 8)
SPAWN_TIMEOUT = 300.0
B = 8  # 4 rows per data rank; the JAX mesh's 4 data devices take 2 each


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


# ------------------------------------------------------------------- inputs
def knn_case(shared: bool, extras: bool):
    """4 problems of 96 queries against 301-row maps (padding on the last
    shard) with exact duplicates across the shard border, so ties cross
    shards; ``extras``: 3 payload columns and a per-query radius."""
    rng = np.random.RandomState(5 + 2 * shared + extras)
    q = rng.uniform(-5, 5, (4, 96, 3)).astype(np.float32)
    p = rng.uniform(-5, 5, ((301, 3) if shared else (4, 301, 3))).astype(np.float32)
    p[..., 160:170, :] = p[..., 0:10, :]
    q[:, :10] = p[..., :10, :]
    payload = rng.randn(*p.shape).astype(np.float32) if extras else None
    radius = rng.uniform(0.05, 3.0, (4, 96)).astype(np.float32) if extras else None
    return q, p, radius, payload


KNN_CASES = {f"{'shared' if s else 'per-problem'} map{', payload + radius' if e else ''}":
             (s, e) for s in (False, True) for e in (False, True)}


def corridor_batch():
    """B scans of 256 points along a 200 m corridor of 8192 rows (walls and
    cross walls) against that one map, each guessed at its own x: the
    shared-map case whose shards (4096 rows) each crop to 1024 rows
    without overflow."""
    rng = np.random.RandomState(11)
    n = 1 << 13
    t = rng.uniform(0, 200, n)
    kind = rng.randint(0, 4, n)
    y = np.where(kind == 0, -5.0, np.where(kind == 1, 5.0, rng.uniform(-5, 5, n)))
    z = np.where(kind < 2, rng.uniform(0, 3, n), np.where(kind == 2, 0.0, rng.uniform(0, 2.5, n)))
    x = np.where(kind == 3, np.round(t / 5.0) * 5.0, t)
    scene = np.stack([x, y, z], 1).astype(np.float32)
    locals_, guesses = [], []
    for b in range(B):
        cx = 30.0 + 20.0 * b
        gt = se3.from_xyz_ypr(cx + 0.3, -0.2, 0.05, 0.03, -0.01, 0.02, device="cpu")
        near = scene[np.abs(scene[:, 0] - cx) < 4.0]
        scan = near[rng.choice(near.shape[0], 256, replace=False)]
        local = se3.apply(se3.inverse(gt), torch.from_numpy(scan)).numpy()
        locals_.append({"raw": {"xyz": local, "count": np.int32(256)}})
        guesses.append((np.eye(3, dtype=np.float32), np.array([cx, 0, 0], np.float32)))
    glob = {"raw": {"xyz": scene, "count": np.int32(n)}}
    return glob, locals_, guesses


def own_matcher_icp():
    """The dry run's ICP with a paired-ratio quality of its own matcher,
    tested at a checkpoint after iteration 2 and at the end."""
    icp = dryrun.make_icp()
    return type(icp)(matchers=icp.matchers, solvers=icp.solvers, quality_evaluators=[
        QualityPairedRatio(reuse_icp_pairings=False,
                           matcher=MatcherPointsDistanceThreshold(threshold=0.5))])


def batch_cases():
    """name -> (icp, params, globals (list: per problem; dict: shared),
    locals, guesses)."""
    globs, locals_, guesses = dryrun.batch_problems(B // 2)
    c_glob, c_locals, c_guesses = corridor_batch()
    return {
        "per-problem maps": (dryrun.make_icp(), ICPParameters(max_iterations=5), globs,
                             locals_, guesses),
        "shared map, cropped": (dryrun.make_icp(),
                                ICPParameters(max_iterations=20, crop_capacity=1024,
                                              crop_extra_margin=1.0),
                                c_glob, c_locals, c_guesses),
        "quality of its own matcher": (own_matcher_icp(),
                                       ICPParameters(max_iterations=5,
                                                     quality_checkpoints=((1, 0.01),)),
                                       globs, locals_, guesses),
    }


@pytest.fixture(scope="module")
def cases(_ask_for_the_cpu):
    return {"knn": {name: knn_case(*flags) for name, flags in KNN_CASES.items()},
            "batch": batch_cases()}


@pytest.fixture(scope="module")
def mesh_ranks(cases):
    """Every case on a 2 x 2 mesh of 4 gloo ranks, in one spawn."""
    tasks = [(ranks.batched_sharded_knn, (q, p, KS, r, pl, N_SPACE))
             for q, p, r, pl in cases["knn"].values()]
    tasks += [(ranks.data_parallel_batch, (icp, params, locals_, globs, guesses, 0, N_SPACE))
              for icp, params, globs, locals_, guesses in cases["batch"].values()]
    out = spawn_ranks(ranks.sequence, RANKS, "gloo", args=(tasks,), device="cpu",
                      timeout=SPAWN_TIMEOUT)
    n_knn = len(KNN_CASES)
    return {"knn": {name: [r[i] for r in out] for i, name in enumerate(KNN_CASES)},
            "batch": {name: [r[n_knn + i] for r in out]
                      for i, name in enumerate(cases["batch"])}}


def one_process(icp, params, globs, locals_, guesses):
    """The port's unsharded batch on the CPU: R, t, iterations,
    terminations, qualities."""
    from mp2p_icp_tpu_torch.parallel.batch import make_batched_align, stack_pytrees

    shared = isinstance(globs, dict)

    def layers(d):
        return {k: ranks._cloud(v) for k, v in d.items()}

    res = make_batched_align(icp, params, broadcast_globals=shared)(
        stack_pytrees([layers(x) for x in locals_]),
        layers(globs) if shared else stack_pytrees([layers(g) for g in globs]),
        stack_pytrees([se3.Pose(torch.from_numpy(R), torch.from_numpy(t)) for R, t in guesses]))
    return {"R": res.optimal_tf.R.numpy(), "t": res.optimal_tf.t.numpy(),
            "iterations": res.n_iterations.numpy(),
            "termination": res.termination_reason.numpy(), "quality": res.quality.numpy()}


@pytest.fixture(scope="module")
def one_process_batches(cases):
    return {name: one_process(*case) for name, case in cases["batch"].items()}


# -------------------------------------------------- the vmapped sharded kNN
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", list(KNN_CASES))
def test_vmapped_sharded_knn_equals_loop_and_one_sweep(cases, mesh_ranks, case, k):
    q, p, radius, payload = cases["knn"][case]
    shared = p.ndim == 2
    nq = q.shape[:2]
    ref = nnb.knn_bruteforce_batched(
        torch.from_numpy(q), torch.ones(nq, dtype=torch.bool), torch.from_numpy(p),
        torch.ones(p.shape[:-1], dtype=torch.bool), k=k,
        max_radius_sq=None if radius is None else torch.from_numpy(radius))
    ok = ref.valid.numpy()
    for rank in mesh_ranks["knn"][case]:
        got, loop = rank[k]["vmapped"], rank[k]["loop"]
        for field in ("idx", "dist_sq", "xyz"):
            np.testing.assert_array_equal(got[field], loop[field])
        np.testing.assert_array_equal(got["idx"], ref.idx.numpy())
        np.testing.assert_array_equal(got["dist_sq"], ref.dist_sq.numpy())
        rows = ref.idx.numpy()
        for b in range(q.shape[0]):
            pb = p if shared else p[b]
            np.testing.assert_array_equal(got["xyz"][b][ok[b]], pb[rows[b][ok[b]]])
            if payload is not None:
                plb = payload if shared else payload[b]
                np.testing.assert_array_equal(got["payload"][b][ok[b]], plb[rows[b][ok[b]]])
        if payload is not None:
            np.testing.assert_array_equal(got["payload"], loop["payload"])
        else:
            assert got["payload"] is None


@pytest.mark.parametrize("case", list(KNN_CASES))
def test_vmapped_sharded_knn_gathers_once_for_the_batch(mesh_ranks, case):
    """One all_gather per vmapped call (4 problems), and no kernel launch
    (CPU tensors run the plain sweep)."""
    for rank in mesh_ranks["knn"][case]:
        assert rank["shard_rows"] == 151
        for k in KS:
            assert rank[k]["gathers"] == 1
            assert sum(rank[k]["launches"].values()) == 0


@pytest.mark.parametrize("ids_batched", [True, False])
def test_space_gather_vmap_rule_moves_the_batch_to_axis_one(ids_batched):
    """The rule on one rank (an axis of size 1): per problem [Q, k, F] and
    [Q, k] in (the ids may be shared by the batch), [1, Q, k, F] and [1, Q,
    k] out, as a loop gives them, the int32 ids to the bit (-1 and values
    above 2^24 included); one collective for the batch."""
    from torch.func import vmap

    vals = torch.randn(2, 3, 2, 5)
    ids = torch.tensor([[[-1, 7], [2**30 + 3, 0], [5, -1]],
                        [[1, 2**24 + 1], [-1, 4], [3, 9]]], dtype=torch.int32)
    if not ids_batched:
        ids = ids[0]
    axis = MeshAxis("space", 1, 0)
    nnb.knn_sharded.gathers = 0
    got_v, got_i = vmap(lambda v, i: nnb._SpaceGather.apply(v, i, axis),
                        in_dims=(1, 0 if ids_batched else None))(vals.movedim(0, 1), ids)
    assert nnb.knn_sharded.gathers == 1
    assert got_i.dtype == torch.int32
    assert torch.equal(got_v, vals[:, None])
    assert torch.equal(got_i, (ids if ids_batched else ids.expand(2, -1, -1))[:, None])


# --------------------------------------------------- the batch on the mesh
@pytest.mark.parametrize("case", ["per-problem maps", "shared map, cropped",
                                  "quality of its own matcher"])
def test_mesh_batch_equals_one_process(mesh_ranks, one_process_batches, case):
    ref = one_process_batches[case]
    for rank in mesh_ranks["batch"][case]:
        assert rank["mesh"] == {"data": RANKS // N_SPACE, "space": N_SPACE}
        assert rank["rows"] == B * N_SPACE // RANKS
        for field in ("R", "t", "iterations", "termination", "quality"):
            np.testing.assert_array_equal(rank[field], ref[field], err_msg=field)


@pytest.mark.parametrize("case", ["per-problem maps", "shared map, cropped",
                                  "quality of its own matcher"])
def test_mesh_batch_gathers_once_per_matcher_call(mesh_ranks, case):
    """Each iteration of the rows' loop gathers once for the whole batch;
    an evaluator with its own matcher once more at its checkpoint and once
    for the final quality. The ranks of a data row gather alike."""
    per_rank = mesh_ranks["batch"][case]
    for r, rank in enumerate(per_rank):
        d = r // N_SPACE
        its = rank["iterations"][d * rank["rows"]:(d + 1) * rank["rows"]]
        expected = int(its.max())
        if case == "quality of its own matcher":
            expected += (int(its.max()) >= 2) + 1
        assert rank["gathers"] == expected, (r, rank["gathers"], its)
        assert rank["gathers"] == per_rank[d * N_SPACE]["gathers"]


def test_mesh_batch_equals_one_process_at_a_wider_crop(mesh_ranks, cases):
    """The shards' crop of 1024 rows against one process that crops the
    whole map to 4096 (chip_smoke.py's data x space phase sizes the two
    crops so): each keeps every in-box row in order, so the poses are the
    same to the bit."""
    icp, params, globs, locals_, guesses = cases["batch"]["shared map, cropped"]
    ref = one_process(icp, dataclasses.replace(params, crop_capacity=4096), globs, locals_,
                      guesses)
    for rank in mesh_ranks["batch"]["shared map, cropped"]:
        for field in ("R", "t", "iterations", "termination", "quality"):
            np.testing.assert_array_equal(rank[field], ref[field], err_msg=field)


def test_mesh_batch_shards_crop_without_overflow(mesh_ranks):
    """The shared corridor's shards (4096 rows) are above the crop capacity,
    so each rank crops its shard at each guess; no shard's box holds more
    rows than the crop keeps (the case where the batch equals one process
    to the bit)."""
    for rank in mesh_ranks["batch"]["shared map, cropped"]:
        boxes = rank["in_box"]["raw"]
        assert len(boxes) == rank["rows"]
        assert all(0 < n <= 1024 for n in boxes), boxes


@pytest.fixture(scope="module")
def jax_batches(cases):
    import __graft_entry__ as graft
    from mp2p_icp_tpu.icp import ICPParameters as JParams

    import torch_parallel_reference as pref

    out = {}
    for name in ("per-problem maps", "shared map, cropped"):
        _, params, globs, locals_, guesses = cases["batch"][name]
        jparams = JParams(max_iterations=params.max_iterations, crop_capacity=params.crop_capacity,
                          crop_extra_margin=params.crop_extra_margin)
        out[name] = pref.jax_data_space_batch(graft._make_icp(), jparams, globs, locals_,
                                              guesses, shared=isinstance(globs, dict))
    return out


@pytest.mark.parametrize("case", ["per-problem maps", "shared map, cropped"])
def test_mesh_batch_within_align_band_of_jax(mesh_ranks, jax_batches, case):
    want = jax_batches[case]
    got = mesh_ranks["batch"][case][0]
    assert np.abs(got["t"] - np.asarray(want["t"])).max() < 5e-3
    assert np.abs(got["R"] - np.asarray(want["R"])).max() < 5e-3
    assert np.abs(got["iterations"] - np.asarray(want["iterations"])).max() <= 1
    np.testing.assert_array_equal(got["termination"], want["termination"])


def test_own_shard_is_this_ranks_shard():
    """own_shard of one map and of a batch of maps: shard_global_layers at
    the rank, per problem."""
    rng = np.random.RandomState(3)
    xyz = torch.from_numpy(rng.randn(2, 11, 3).astype(np.float32))
    layers = {"raw": PointCloud(
        xyz=xyz, count=torch.tensor([11, 7], dtype=torch.int32))}
    for rank in range(3):
        axis = MeshAxis("space", 3, rank)
        got = own_shard(layers, axis, batched=True)["raw"]
        for b in range(2):
            one = {"raw": PointCloud(
                xyz=xyz[b], count=layers["raw"].count[b])}
            want = shard_global_layers(one, 3)["raw"]
            assert torch.equal(got.xyz[b], want.xyz[rank])
            assert int(got.count[b]) == int(want.count[rank])
            assert torch.equal(own_shard(one, axis)["raw"].xyz, want.xyz[rank])


def test_spatial_icp_sets_the_axis_of_every_matcher():
    axis = MeshAxis("space", 2, 1)
    icp = spatial_icp(own_matcher_icp(), axis)
    assert all(m.spatial_axis is axis for m in icp.matchers)
    assert icp.quality_evaluators[0].matcher.spatial_axis is axis
    assert dryrun.make_icp().matchers[0].spatial_axis is None


# ------------------------------------------------------------- the dry run
def test_spawn_ranks_kills_ranks_past_the_timeout():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError):
        spawn_ranks(time.sleep, 2, "gloo", args=(120,), device="cpu", timeout=5)
    assert time.perf_counter() - t0 < 60


def test_spawn_ranks_file_start_leaves_the_mp2p_variables(monkeypatch):
    """A file start neither sets nor restores the MP2P_* variables, so it
    may run beside an env start (the dry run's two spawns)."""
    monkeypatch.setenv("MP2P_COORDINATOR", "localhost:1")
    monkeypatch.delenv("MP2P_NUM_PROCESSES", raising=False)
    assert spawn_ranks(ranks.sequence, 1, "gloo", args=([],), device="cpu",
                       timeout=SPAWN_TIMEOUT) == [[]]
    assert os.environ["MP2P_COORDINATOR"] == "localhost:1"
    assert "MP2P_NUM_PROCESSES" not in os.environ


def test_dryrun_backend_follows_the_device():
    assert dryrun.choose_backend(4, "cpu") == ("gloo", "cpu")
    assert dryrun.mesh_shape(4) == (2, 2) and dryrun.mesh_shape(2) == (2, 1)
    assert dryrun.mesh_shape(8) == (4, 2) and dryrun.mesh_shape(3) == (3, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dryrun.choose_backend(4, "cuda")


@pytest.fixture(scope="module")
def dryrun_runs():
    """The script with 2 and 4 ranks on the CPU, both at once, each under
    its own timeout."""
    procs = {n: subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / "torch_multichip_dryrun.py"), str(n),
         "--device", "cpu"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for n in (2, 4)}
    out = {}
    for n, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, stderr = p.communicate()
        out[n] = (p.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_script_passes_on_the_cpu(dryrun_runs, n):
    rc, stdout, stderr = dryrun_runs[n]
    assert rc == 0, stdout[-3000:] + stderr[-3000:]
    lines = stdout.strip().splitlines()
    n_data, n_space = dryrun.mesh_shape(n)
    assert lines[-2].startswith(f"dryrun_multichip OK: mesh data={n_data} space={n_space}, "
                                f"B={2 * n_data}, translation errors=[")
    assert f"spatial-sharded align over {n} shards err=" in lines[-2]
    assert "sharded-odometry max terr=" in lines[-2]
    assert lines[-2].endswith("multihost 2-process dryrun ok=True")
    assert lines[-1] == f"backend: gloo ({n} ranks, on the CPU)"


def test_new_scripts_import_nothing_of_the_jax_side():
    """The dry run and the odometry demo import torch, numpy and the port:
    neither jax nor the JAX package (the twin of the check on
    chip_smoke.py)."""
    code = (
        "import sys; sys.path.insert(0, 'scripts'); "
        "import torch_multichip_dryrun, torch_demo_odometry; "
        "bad = [m for m in ('jax', 'mp2p_icp_tpu', 'bench') if m in sys.modules]; "
        "assert not bad, bad; "
        "assert callable(torch_multichip_dryrun.main) and callable(torch_demo_odometry.main); "
        "assert 'mp2p_icp_tpu_torch' in sys.modules"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO)
    assert out.returncode == 0, out.stderr
