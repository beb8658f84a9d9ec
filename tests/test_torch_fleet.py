"""Fleet odometry on the CPU: B streams per frame through one step.

Three contracts, each with its tolerance stated where it is used:

- every stage that took a leading batch axis (FirstPoint selection, deskew,
  decimation with both backends, merge, voxel-hash insert, normals fit)
  gives, for a stack of B inputs, exactly what B sequential calls give;
  the insert's probe loop reads the host once per round for the whole
  batch;
- ``BatchedOdometryMapper.run`` equals the port's own sequential runs (R and
  t within 1e-5, equal iterations, map counts and map rows, both map modes)
  and tracks the JAX package's ``BatchedOdometryMapper.run`` (per-stream ATE
  within max(1.5 x, + 0.01 m), map count within 2%); one fleet step from the
  JAX package's stacked state lands within 5e-3 of its vmapped step;
- ``run_offline`` equals ``run`` exactly, for one stream and for a fleet.

The size is that of tests/test_torch_odometry.py (32 rings x 512 azimuths,
its capacities and its WORLD_SHIFT); the fleet is B = 2 streams of 6 frames
starting at frames 0 and 8 of one drive.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.odometry import BatchedOdometryMapper as JBatchedOdometryMapper
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.eval.lidar_sim import make_street_sequence, scan_to_pointcloud
from mp2p_icp_tpu_torch.eval.trajectory import ate_rmse
from mp2p_icp_tpu_torch.filters import FilterDecimateVoxels, FilterDeskew, FilterMerge
from mp2p_icp_tpu_torch.odometry import BatchedOdometryMapper
from mp2p_icp_tpu_torch.ops import voxel_hash_map as vhm
from mp2p_icp_tpu_torch.ops.normals import estimate_point_normals
from mp2p_icp_tpu_torch.ops.voxel_unique import first_point_select
from mp2p_icp_tpu_torch.parallel import stack_pytrees
from test_torch_odometry import DT, JAX, PORT, RAW_CAP, WORLD_SHIFT, _mapper, _voxel_set


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


N_FRAMES, OFFSETS = 6, (0, 8)
B = len(OFFSETS)


def _assert_trees_equal(a, b):
    """Two pytrees of tensors (states, clouds, tuples of them), leaf for leaf."""
    la, lb = (torch.utils._pytree.tree_leaves(x) for x in (a, b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


def _cloud(rng, n, cap, spread=20.0, channels=False):
    xyz = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    extra = ({"intensity": rng.rand(n), "ring": rng.randint(0, 32, n), "time": rng.uniform(-.05, .05, n)}
             if channels else {})
    return PointCloud.from_numpy(xyz, capacity=cap, **extra)


# ------------------------------------------------------------------ stages
@pytest.mark.parametrize("flatten_z", [False, True])
def test_first_point_select_batched_equals_sequential(flatten_z):
    rng = np.random.RandomState(0)
    xyz = torch.from_numpy(rng.uniform(-6, 6, (3, 500, 3)).astype(np.float32))
    valid = torch.from_numpy(rng.rand(3, 500) > 0.2)
    valid[2] = False  # a problem with no valid point
    for out_cap in (500, 64):  # 64: fewer slots than voxels
        sel, n = first_point_select(xyz, valid, 1.0, out_cap, flatten_z=flatten_z)
        assert sel.shape == (3, out_cap) and n.shape == (3,)
        for b in range(3):
            sel_b, n_b = first_point_select(xyz[b], valid[b], 1.0, out_cap, flatten_z=flatten_z)
            assert torch.equal(sel[b], sel_b) and int(n[b]) == int(n_b)
        assert int(n[2]) == 0 and bool((sel[2] == 500).all())


@pytest.mark.parametrize("backend", ["sort", "hash"])
def test_filters_batched_equal_sequential(backend):
    """Deskew with one twist per stream, FirstPoint decimation (both
    backends) and FilterMerge on a stack of clouds, exactly."""
    rng = np.random.RandomState(1)
    clouds = [_cloud(rng, n, 1024, channels=True) for n in (900, 1024, 3)]
    twists = torch.from_numpy(rng.randn(3, 6).astype(np.float32) * 0.5)
    twists[1, 3:] = 0.0  # |w| = 0: the small-angle branch for one stream only
    filters = [FilterDeskew(input_pointcloud_layer="raw", output_pointcloud_layer="deskewed"),
               FilterDecimateVoxels(input_pointcloud_layer=("deskewed",),
                                    output_pointcloud_layer="decimated",
                                    voxel_filter_resolution=2.0, output_capacity=512,
                                    backend=backend),
               FilterMerge(input_pointcloud_layer="decimated", target_layer="map",
                           target_capacity=700)]
    names = ("vx", "vy", "vz", "wx", "wy", "wz")

    def run(layers, tw):
        variables = {k: tw[..., i] for i, k in enumerate(names)}
        for f in filters:
            layers = f(layers, variables)
        return FilterMerge(input_pointcloud_layer="deskewed", target_layer="map")(layers)

    out = run({"raw": stack_pytrees(clouds)}, twists)
    assert out["map"].xyz.shape == (3, 700, 3) and out["decimated"].count.shape == (3,)
    for b in range(3):
        seq = run({"raw": clouds[b]}, twists[b])
        for name in ("deskewed", "decimated", "map"):
            _assert_trees_equal(convert.unstack(out[name])[b], seq[name])
    assert int(out["map"].count[0]) == 700  # the second merge overflowed: dropped alike


def test_decimate_bypass_batched_equals_sequential():
    """minimum_input_points_to_filter: one stream's cloud is copied through
    while the other's is decimated, in one call."""
    rng = np.random.RandomState(2)
    clouds = [_cloud(rng, 40, 256, channels=True), _cloud(rng, 200, 256, channels=True)]
    f = FilterDecimateVoxels(input_pointcloud_layer=("raw",), voxel_filter_resolution=8.0,
                             minimum_input_points_to_filter=50, output_capacity=256)
    out = f({"raw": stack_pytrees(clouds)})["decimated"]
    assert int(out.count[0]) == 40 and int(out.count[1]) < 200
    for b in range(2):
        _assert_trees_equal(convert.unstack(out)[b], f({"raw": clouds[b]})["decimated"])


def _insert_cases():
    """(name, capacity, table size, per-stream list of clouds to insert one
    after another). Stream 1 of "idle" has nothing to insert while stream
    0's points, all in one voxel column of a tiny table, probe for rounds."""
    rng = np.random.RandomState(3)

    def pts(n, spread):
        return rng.uniform(-spread, spread, (n, 3)).astype(np.float32)

    overlap = pts(600, 8.0)
    column = np.stack([np.zeros(64), np.zeros(64), np.arange(64) * 1.0 + 0.5], 1).astype(np.float32)
    return [
        ("overlapping", 2048, None, [[overlap[:400], overlap[200:]], [pts(400, 5.0), pts(400, 9.0)]]),
        ("full_buffer", 128, None, [[pts(300, 9.0), pts(300, 9.0)], [pts(100, 9.0), pts(300, 9.0)]]),
        ("tiny_table", 64, 16, [[pts(200, 9.0), pts(200, 9.0)], [pts(200, 3.0), pts(10, 9.0)]]),
        ("idle", 256, 16, [[column, column + 0.25], [np.zeros((0, 3), np.float32)] * 2]),
    ]


@pytest.mark.parametrize("case", _insert_cases(), ids=lambda c: c[0])
def test_hash_map_insert_batched_equals_sequential(case, monkeypatch):
    name, cap, table, streams = case
    n_b = len(streams)
    rounds, reads = [], []
    real_reduce, real_bool = torch.Tensor.scatter_reduce_, torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "scatter_reduce_",
                        lambda self, *a, **k: (rounds.append(1), real_reduce(self, *a, **k))[1])
    monkeypatch.setattr(torch.Tensor, "__bool__",
                        lambda self: (reads.append(1), real_bool(self))[1])

    def clouds(step):
        return [PointCloud.from_numpy(s[step], capacity=512) for s in streams]

    seq_states = [vhm.empty_voxel_hash_map(cap, table_size=table, normals=False) for _ in range(n_b)]
    state = vhm.empty_voxel_hash_map(cap, table_size=table, batch=(n_b,))
    _assert_trees_equal(convert.unstack(state)[0], seq_states[0])
    for step in range(2):
        new = clouds(step)
        seq_rounds = []
        for b in range(n_b):
            del rounds[:]
            seq_states[b], dest_b = vhm.hash_map_insert(seq_states[b], new[b], 1.0, with_dest=True)
            seq_rounds.append(len(rounds))
            new[b] = (new[b], dest_b)
        del rounds[:], reads[:]
        state, dest = vhm.hash_map_insert(state, stack_pytrees([c for c, _ in new]), 1.0,
                                          with_dest=True)
        # the fleet runs as many rounds as its slowest map, and reads the
        # host once per round after the unconditional ones: not per map
        assert len(rounds) == max(seq_rounds)
        assert len(reads) == max(len(rounds) - vhm.ROUNDS_BEFORE_CHECK, 0) + 1
        for b in range(n_b):
            _assert_trees_equal(convert.unstack(state)[b], seq_states[b])
            assert torch.equal(dest[b], new[b][1])
    if name == "full_buffer":
        assert int(state.pc.count[0]) == cap and int(state.n_dropped[0]) > 0
    if name == "tiny_table":
        assert int(state.n_dropped.min()) > 0  # probe chains ran out in both
    if name == "idle":
        assert max(seq_rounds) >= 5 and seq_rounds[1] == vhm.ROUNDS_BEFORE_CHECK
        assert int(state.pc.count[1]) == 0 and int(state.pc.count[0]) > 0


def test_hash_decimate_batched_equals_sequential():
    rng = np.random.RandomState(4)
    clouds = [_cloud(rng, n, 512, spread=6.0, channels=True) for n in (512, 77)]
    out = vhm.hash_decimate_first_point(stack_pytrees(clouds), 1.5, 256)
    for b in range(2):
        _assert_trees_equal(convert.unstack(out)[b], vhm.hash_decimate_first_point(clouds[b], 1.5, 256))


def test_estimate_point_normals_batched_equals_sequential():
    """Own neighbourhoods, and a denser source with an explicit validity
    (the winners-only fit of the odometry step), exactly."""
    gt, twists, scans = make_street_sequence(2, n_rings=16, n_azimuth=256)
    dense = [scan_to_pointcloud(s, capacity=4096) for s in scans]
    query = [PointCloud(xyz=pc.xyz[::5].contiguous(), count=(pc.count + 4) // 5) for pc in dense]
    sv = torch.stack([pc.valid_mask() & (torch.arange(4096) % 7 != 0) for pc in dense])
    own = estimate_point_normals(stack_pytrees(query), knn=8, max_radius=1.5)
    fit = estimate_point_normals(stack_pytrees(query), knn=8, max_radius=1.5,
                                 source=stack_pytrees(dense), source_valid=sv)
    assert fit.normals.shape == (2, 820, 3) and float(fit.normals.abs().sum()) > 100
    for b in range(2):
        _assert_trees_equal(convert.unstack(own)[b],
                            estimate_point_normals(query[b], knn=8, max_radius=1.5))
        _assert_trees_equal(convert.unstack(fit)[b], estimate_point_normals(
            query[b], knn=8, max_radius=1.5, source=dense[b], source_valid=sv[b]))


# ------------------------------------------------------------------- fleet
@pytest.fixture(scope="module")
def fleet():
    """One drive, B streams cut from it at OFFSETS, in both packages."""
    n = max(OFFSETS) + N_FRAMES
    gt, twists, scans = make_street_sequence(n, n_rings=32, n_azimuth=512)
    gt[:, :3, 3] += WORLD_SHIFT
    frames_t = [{"raw": scan_to_pointcloud(s, capacity=RAW_CAP)} for s in scans]
    frames_j = [{"raw": JPointCloud.from_numpy(
        s["xyz"][s["valid"]], capacity=RAW_CAP, intensity=s["intensity"][s["valid"]],
        ring=s["ring"][s["valid"]], time=s["time"][s["valid"]])} for s in scans]
    cut = lambda xs: [xs[o:o + N_FRAMES] for o in OFFSETS]  # noqa: E731
    return {
        "gt": cut(gt), "twists": cut(twists), "frames_t": cut(frames_t), "frames_j": cut(frames_j),
        "p0_t": [convert.pose_from_numpy(gt[o, :3, :3], gt[o, :3, 3]) for o in OFFSETS],
        "p0_j": [jse3.Pose(jnp.asarray(gt[o, :3, :3], jnp.float32),
                           jnp.asarray(gt[o, :3, 3], jnp.float32)) for o in OFFSETS],
    }


@pytest.fixture(scope="module")
def jax_fleet():
    """The JAX package's fleet mapper (its vmapped step compiles once)."""
    return JBatchedOdometryMapper(_mapper(JAX))


@pytest.fixture(scope="module")
def port_runs(fleet):
    """The port's fleet run and its sequential runs, per map mode."""
    out = {}
    for incremental in (True, False):
        mapper = _mapper(PORT, incremental=incremental)
        out[incremental] = (
            BatchedOdometryMapper(mapper).run(fleet["frames_t"], twists=fleet["twists"],
                                              initial_poses=fleet["p0_t"], dt=DT),
            [mapper.run(fleet["frames_t"][b], twists=fleet["twists"][b],
                        initial_pose=fleet["p0_t"][b], dt=DT) for b in range(B)])
    return out


def test_one_fleet_step_from_the_jax_stacked_state(fleet, jax_fleet):
    """Seed both streams in the JAX package, carry the stacked state across
    with convert.py, run frame 1 of every stream in one step of each
    package."""
    jm, tm = jax_fleet.mapper, _mapper(PORT)
    tw = np.stack(fleet["twists"])  # [B, N, 6]
    seeds_j = [jm.seed_map(fleet["frames_j"][b][0], fleet["p0_j"][b], jnp.asarray(tw[b, 0]))
               for b in range(B)]
    state_t = convert.stacked_voxel_hash_maps_from_jax(seeds_j)
    state_j = jax.tree.map(lambda *xs: jnp.stack(xs), *seeds_j)
    _assert_trees_equal(state_t, convert.stacked_voxel_hash_maps_from_jax(state_j))
    back = convert.voxel_hash_map_to_numpy(convert.unstack(state_t)[1])
    np.testing.assert_array_equal(back["table_k1"], np.asarray(seeds_j[1].table_k1))
    count0 = state_t.pc.count.clone()

    p0_t = stack_pytrees(fleet["p0_t"])
    ident = se3.Pose(torch.eye(3).expand(B, 3, 3), torch.zeros(B, 3))
    new_t, res_t, _ = tm._step(
        state_t, stack_pytrees([fleet["frames_t"][b][1] for b in range(B)]), p0_t, ident,
        torch.from_numpy(tw[:, 1]), torch.from_numpy(tw[:, 0]), True, DT)
    stack_j = lambda xs: jax.tree.map(lambda *ys: jnp.stack(ys), *xs)  # noqa: E731
    new_j, pose_j, _, q_j, _ = jax_fleet._get_vstep(DT)(
        state_j, stack_j([fleet["frames_j"][b][1] for b in range(B)]), stack_j(fleet["p0_j"]),
        stack_j([jse3.identity()] * B), jnp.asarray(tw[:, 1]), jnp.asarray(tw[:, 0]),
        jnp.asarray(True))

    assert res_t.n_iterations.shape == (B,) and new_t.pc.xyz.shape[0] == B
    for b in range(B):
        # iterations and termination of the JAX align from the same state
        l_j = jm.filters[1](jm.filters[0](dict(fleet["frames_j"][b][1]), dict(zip(
            ("vx", "vy", "vz", "wx", "wy", "wz"), jnp.asarray(tw[b, 1])))))
        guess_j = jse3.compose(fleet["p0_j"][b], jse3.exp(jnp.float32(DT) * jnp.asarray(tw[b, 0])))
        res_j = jm.icp.align({"decimated": l_j["decimated"]}, {"map": seeds_j[b].pc}, guess_j,
                             jm.params)
        pose_jt = convert.pose_from_numpy(np.asarray(pose_j.R[b]), np.asarray(pose_j.t[b]))
        gap = float(se3.error_log_norm(
            pose_jt, se3.Pose(res_t.optimal_tf.R[b], res_t.optimal_tf.t[b])))
        assert gap < 5e-3, (b, gap)  # pose within 5e-3
        assert abs(int(res_t.n_iterations[b]) - int(res_j.n_iterations)) <= 1  # iterations +-1
        assert int(res_t.termination_reason[b]) == int(res_j.termination_reason)
        assert abs(float(res_t.quality[b]) - float(q_j[b])) < 0.02
        c0, n_t, n_j = int(count0[b]), int(new_t.pc.count[b]), int(new_j.pc.count[b])
        assert n_t > c0 + 50
        vox_t = _voxel_set(new_t.pc.xyz[b].numpy()[c0:], n_t - c0)
        vox_j = _voxel_set(np.asarray(new_j.pc.xyz[b])[c0:], n_j - c0)
        jaccard = len(vox_t & vox_j) / len(vox_t | vox_j)
        assert jaccard >= 0.97, (b, jaccard)  # inserted voxels
        assert int(new_t.n_dropped[b]) == int(new_j.n_dropped[b]) == 0


@pytest.mark.parametrize("incremental", [True, False], ids=["hash_map", "sort_maintenance"])
def test_fleet_equals_the_sequential_runs(fleet, port_runs, incremental):
    rb, seqs = port_runs[incremental]
    assert rb["poses"].shape == (B, N_FRAMES, 4, 4)
    assert rb["qualities"].shape == rb["iterations"].shape == rb["map_counts"].shape == (B, N_FRAMES - 1)
    assert rb["frame_seconds"].shape == (N_FRAMES - 1,) and rb["scans_per_s"] > 0
    for b, rs in enumerate(seqs):
        assert np.abs(rb["poses"][b] - rs["poses"]).max() <= 1e-5  # R and t within 1e-5
        np.testing.assert_array_equal(rb["iterations"][b], rs["iterations"])
        np.testing.assert_array_equal(rb["map_counts"][b], rs["map_counts"])
        np.testing.assert_allclose(rb["qualities"][b], rs["qualities"], atol=1e-6)
        # the same map, row for row
        assert torch.equal(rb["maps"].xyz[b], rs["map"].xyz)
        if incremental:
            _assert_trees_equal(convert.unstack(rb["map_states"])[b], rs["map_state"])
            assert int(rb["map_states"].n_dropped[b]) == 0
        assert ate_rmse(rb["poses"][b], fleet["gt"][b]) < 0.1
    assert rb["iterations"].max() >= 3


def test_fleet_tracks_the_jax_fleet(fleet, jax_fleet, port_runs):
    rj = jax_fleet.run(fleet["frames_j"], twists=fleet["twists"], initial_poses=fleet["p0_j"],
                       dt=DT)
    rt, _ = port_runs[True]
    assert rj["poses"].shape == rt["poses"].shape
    for b in range(B):
        ate_j, ate_t = (ate_rmse(r["poses"][b], fleet["gt"][b]) for r in (rj, rt))
        assert ate_t <= max(1.5 * ate_j, ate_j + 0.01), (b, ate_t, ate_j)  # max(1.5 x, + 0.01 m)
        n_j, n_t = int(np.asarray(rj["maps"].count)[b]), int(rt["maps"].count[b])
        assert abs(n_t - n_j) <= 0.02 * n_j, (b, n_t, n_j)  # map count within 2%
    assert np.abs(rt["qualities"] - rj["qualities"]).max() < 0.05


@pytest.mark.parametrize("with_dt", [True, False], ids=["dt", "no_dt"])
@pytest.mark.parametrize("as_fleet", [False, True], ids=["one_stream", "fleet"])
def test_run_offline_equals_run(fleet, as_fleet, with_dt):
    """merge_every=3 (frames 3 merge, the others only align); with the
    motion-model guess and with the previous relative pose."""
    mapper = _mapper(PORT, merge_every=3)
    dt = DT if with_dt else None
    n = 5
    if as_fleet:
        runner = BatchedOdometryMapper(mapper)
        args = ([s[:n] for s in fleet["frames_t"]],)
        kw = dict(twists=[t[:n] for t in fleet["twists"]], initial_poses=fleet["p0_t"], dt=dt)
    else:
        runner = mapper
        args = (fleet["frames_t"][1][:n],)
        kw = dict(twists=fleet["twists"][1][:n], initial_pose=fleet["p0_t"][1], dt=dt)
    a, b = runner.run(*args, **kw), runner.run_offline(*args, **kw)
    assert sorted(a) == sorted(b)
    for key in ("poses", "qualities", "iterations", "map_counts"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    key = "map_states" if as_fleet else "map_state"
    _assert_trees_equal(a[key], b[key])
    counts = a["map_counts"].reshape(-1, n - 1)
    assert (counts[:, 0] == counts[:, 1]).all() and (counts[:, 1] < counts[:, 2]).all()
    assert np.isfinite(a["poses"]).all()


def test_fleet_refuses_ragged_streams(fleet):
    bm = BatchedOdometryMapper(_mapper(PORT))
    with pytest.raises(ValueError, match="equal lengths"):
        bm.run([fleet["frames_t"][0][:3], fleet["frames_t"][1][:2]])
    with pytest.raises(ValueError, match="twist sequences"):
        bm.run([s[:2] for s in fleet["frames_t"]], twists=fleet["twists"][:1])
    assert dataclasses.is_dataclass(bm)
