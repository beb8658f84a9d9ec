"""Parity of the port's voxel hash map with the JAX package on the CPU.

Everything is exact: the voxel keys and the hash bit for bit (cells of both
signs), and after inserts the point buffer (xyz, channels, count), ``dest``,
both key tables and ``n_dropped``: the same table slots and probe chains,
not only the same winners. A hypothesis property holds the buffer to a
numpy dict-based FirstPoint oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.ops import voxel_hash_map as jvhm
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.ops import voxel_hash_map as vhm


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def assert_states_equal(sj, st_):
    assert int(sj.pc.count) == int(st_.pc.count)
    assert int(sj.n_dropped) == int(st_.n_dropped)
    np.testing.assert_array_equal(st_.table_k1.numpy(), np.asarray(sj.table_k1))
    np.testing.assert_array_equal(st_.table_k2.numpy(), np.asarray(sj.table_k2))
    np.testing.assert_array_equal(st_.pc.xyz.numpy(), np.asarray(sj.pc.xyz))
    for name in ("intensity", "ring", "time", "normals"):
        a, b = getattr(sj.pc, name), getattr(st_.pc, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)


def _pair(xyz, cap, **channels):
    pj = JPointCloud.from_numpy(xyz, capacity=cap, **channels)
    return pj, convert.pointcloud_from_jax(pj)


@pytest.mark.parametrize("resolution", [0.5, 1.0, 0.04])
def test_voxel_keys_bit_equal(resolution):
    rng = np.random.RandomState(0)
    xyz = rng.uniform(-120, 120, (6000, 3)).astype(np.float32)
    # cells of both signs, points exactly on cell borders, beyond the cell
    # range (clipped), and padding rows
    xyz[:200] = np.round(xyz[:200] / resolution) * resolution
    xyz[200:220] *= 1000.0
    xyz[5900:] = PointCloud.PAD_VALUE
    valid = rng.rand(6000) > 0.1
    kj = jvhm.voxel_keys(jnp.asarray(xyz), jnp.asarray(valid), resolution)
    kt = vhm.voxel_keys(torch.from_numpy(xyz), torch.from_numpy(valid), resolution)
    # 1e8 / 0.04 leaves int32, where the JAX package's conversion is
    # platform-defined (the port saturates): compare the rows that fit
    ok = np.abs(xyz).max(axis=1) / resolution < 2.0e9
    assert ok.all() == (resolution != 0.04)
    for name, a, b in zip(("k1", "k2", "hash"), kj, kt):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy()[ok], np.asarray(a)[ok], err_msg=name)
    assert (np.asarray(kj[2]) < 0).any() and (np.asarray(kj[2]) > 0).any()


def test_table_size_and_empty_state():
    assert [vhm.table_size_for(c) for c in (1, 256, 257, 32768)] == [
        jvhm.table_size_for(c) for c in (1, 256, 257, 32768)] == [1024, 1024, 2048, 131072]
    sj = jvhm.empty_voxel_hash_map(512, ring=True, normals=True)
    assert_states_equal(sj, vhm.empty_voxel_hash_map(512, ring=True, normals=True))
    assert_states_equal(sj, convert.voxel_hash_map_from_jax(sj))


def test_three_overlapping_inserts_match_jax():
    rng = np.random.RandomState(1)
    sj = jvhm.empty_voxel_hash_map(8192, intensity=True)
    st_ = vhm.empty_voxel_hash_map(8192, intensity=True)
    for frame in range(3):
        n = 3000 + 100 * frame
        xyz = (rng.uniform(-12, 12, (n, 3)) + 2.0 * frame).astype(np.float32)
        channels = dict(intensity=rng.rand(n).astype(np.float32))
        if frame:  # a channel that first appears with a later insert
            channels["time"] = rng.rand(n).astype(np.float32)
        pj, pt = _pair(xyz, 4096, **channels)
        sj, dj = jvhm.hash_map_insert(sj, pj, 1.0, with_dest=True)
        st_, dt = vhm.hash_map_insert(st_, pt, 1.0, with_dest=True)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        assert_states_equal(sj, st_)
    assert int(st_.pc.count) > 5000 and int(st_.n_dropped) == 0
    assert st_.pc.time is not None


def test_insert_leaves_its_input_state_unchanged():
    rng = np.random.RandomState(2)
    st0 = vhm.hash_map_insert(vhm.empty_voxel_hash_map(1024),
                              _pair(rng.uniform(-5, 5, (300, 3)), 512)[1], 1.0)
    before = convert.voxel_hash_map_to_numpy(st0)
    new = _pair(rng.uniform(-8, 8, (400, 3)), 512)[1]
    a = vhm.hash_map_insert(st0, new, 1.0)
    b = vhm.hash_map_insert(st0, new, 1.0)  # the same insert again: equal states
    after = convert.voxel_hash_map_to_numpy(st0)
    for key in ("table_k1", "table_k2", "n_dropped"):
        np.testing.assert_array_equal(before[key], after[key])
    np.testing.assert_array_equal(before["pc"]["xyz"], after["pc"]["xyz"])
    assert int(a.pc.count) > int(st0.pc.count)
    for x, y in zip(convert.voxel_hash_map_to_numpy(a).values(),
                    convert.voxel_hash_map_to_numpy(b).values()):
        np.testing.assert_array_equal(x["xyz"] if isinstance(x, dict) else x,
                                      y["xyz"] if isinstance(y, dict) else y)


def test_full_buffer_rolls_the_table_back():
    rng = np.random.RandomState(3)
    sj, st_ = jvhm.empty_voxel_hash_map(500), vhm.empty_voxel_hash_map(500)
    for _ in range(2):
        pj, pt = _pair(rng.uniform(-10, 10, (1000, 3)).astype(np.float32), 1024)
        sj, dj = jvhm.hash_map_insert(sj, pj, 1.0, with_dest=True)
        st_, dt = vhm.hash_map_insert(st_, pt, 1.0, with_dest=True)
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
        assert_states_equal(sj, st_)
    assert int(st_.pc.count) == 500 and int(st_.n_dropped) > 400
    # every key left in the table belongs to a buffer row
    assert int((st_.table_k1 != vhm.SENTINEL).sum()) == 500


@pytest.mark.parametrize("max_probe", [1, 2, 12])
def test_tiny_table_exhausts_the_probe_chain(max_probe):
    rng = np.random.RandomState(4)
    sj = jvhm.empty_voxel_hash_map(2048, table_size=1024)
    st_ = vhm.empty_voxel_hash_map(2048, table_size=1024)
    pj, pt = _pair(rng.uniform(-10, 10, (1500, 3)).astype(np.float32), 2048)
    valid = rng.rand(2048) > 0.05
    sj, dj = jvhm.hash_map_insert(sj, pj, 1.0, valid=jnp.asarray(valid) & pj.valid_mask(),
                                  max_probe=max_probe, with_dest=True)
    st_, dt = vhm.hash_map_insert(st_, pt, 1.0, valid=torch.from_numpy(valid) & pt.valid_mask(),
                                  max_probe=max_probe, with_dest=True)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    assert_states_equal(sj, st_)
    assert int(st_.n_dropped) > 0  # more voxels than table slots


@pytest.mark.parametrize("rounds", [0, 1, 5])
def test_result_does_not_depend_on_the_unconditional_rounds(monkeypatch, rounds):
    rng = np.random.RandomState(5)
    new = _pair(rng.uniform(-6, 6, (2000, 3)).astype(np.float32), 2048)[1]
    ref = vhm.hash_map_insert(vhm.empty_voxel_hash_map(2048, table_size=4096), new, 1.0)
    monkeypatch.setattr(vhm, "ROUNDS_BEFORE_CHECK", rounds)
    out = vhm.hash_map_insert(vhm.empty_voxel_hash_map(2048, table_size=4096), new, 1.0)
    assert torch.equal(out.table_k1, ref.table_k1) and torch.equal(out.table_k2, ref.table_k2)
    assert torch.equal(out.pc.xyz, ref.pc.xyz) and int(out.n_dropped) == int(ref.n_dropped)


def test_hash_decimate_matches_jax():
    rng = np.random.RandomState(6)
    n = 2500
    pj, pt = _pair(rng.uniform(-9, 9, (n, 3)).astype(np.float32), 4096,
                   ring=rng.randint(0, 8, n).astype(np.float32))
    oj = jvhm.hash_decimate_first_point(pj, 1.5, 1024)
    ot = vhm.hash_decimate_first_point(pt, 1.5, 1024)
    assert int(oj.count) == int(ot.count)
    np.testing.assert_array_equal(ot.xyz.numpy(), np.asarray(oj.xyz))
    np.testing.assert_array_equal(ot.ring.numpy(), np.asarray(oj.ring))


def _oracle(clouds, resolution, capacity):
    """Dict-based FirstPoint: the first point seen in each voxel, in
    insertion order, until the buffer is full."""
    seen, rows = set(), []
    for xyz in clouds:
        for p in xyz:
            cell = tuple(np.floor(p / np.float32(resolution)).astype(np.int64))
            if cell not in seen and len(rows) < capacity:
                seen.add(cell)
                rows.append(p)
    return np.array(rows, np.float32).reshape(-1, 3)


@settings(max_examples=25, deadline=None, database=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 3), st.sampled_from([0.5, 1.0, 3.0]),
       st.sampled_from([64, 400]))
def test_buffer_equals_first_point_oracle(seed, n_clouds, resolution, capacity):
    rng = np.random.RandomState(seed)
    clouds = [rng.uniform(-6, 6, (rng.randint(1, 300), 3)).astype(np.float32)
              for _ in range(n_clouds)]
    state = vhm.empty_voxel_hash_map(capacity)
    for xyz in clouds:
        state = vhm.hash_map_insert(state, PointCloud.from_numpy(xyz, capacity=512), resolution)
    want = _oracle(clouds, resolution, capacity)
    n = int(state.pc.count)
    assert n == len(want)
    np.testing.assert_array_equal(state.pc.xyz.numpy()[:n], want)
    assert (state.pc.xyz[n:] == PointCloud.PAD_VALUE).all()
