"""The port's grid-hash kNN (ops/voxel_hash.py, ops/nn.nn_search) against
the JAX package's, on the CPU.

Mirrors tests/test_nn.py (TestHashGridNN, TestGridVsBruteforceParity):

- build_hash_grid: every field equal to JAX's (exact), at the default and
  at a small table (many collisions), with invalid rows;
- nn_search, k = 1 and 8, with and without a radius: idx, dist_sq and
  valid equal to JAX's (exact), including the duplicate candidates of two
  neighbour cells that collide into one bucket (the reference behaviour,
  kept);
- the JAX tests' envelope cases (exact within the radius against a brute
  force, invalid queries, padding) on the port;
- the grid against the port's exact kNN (knn_bruteforce) on a decimated
  cloud, as TestGridVsBruteforceParity holds JAX's grid to its kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mp2p_icp_tpu_torch
from mp2p_icp_tpu.ops.nn import nn_search as jnn_search
from mp2p_icp_tpu.ops.voxel_hash import build_hash_grid as jbuild
from mp2p_icp_tpu.ops.voxel_hash import hash_cells as jhash_cells
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.ops.nn import NNResult, nn_search
from mp2p_icp_tpu_torch.ops.nn_bruteforce import knn_bruteforce
from mp2p_icp_tpu_torch.ops.voxel_hash import (
    NEIGHBOR_OFFSETS,
    HashGrid,
    build_hash_grid,
    cell_coords,
    hash_cells,
)

FIELDS = ("points_sorted", "order", "valid_sorted", "bucket_start", "bucket_count")


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _cloud(seed=0, n=500, cap=512, spread=10.0, q=64):
    """n points in +-spread at capacity cap (padding at 1e8), q queries."""
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-spread, spread, (cap, 3)).astype(np.float32)
    pts[n:] = 1e8
    valid = np.arange(cap) < n
    queries = rng.uniform(-spread, spread, (q, 3)).astype(np.float32)
    return pts, valid, queries


def _grids(pts, valid, cell, table_size=None):
    return (build_hash_grid(torch.from_numpy(pts), torch.from_numpy(valid), cell, table_size),
            jbuild(jnp.asarray(pts), jnp.asarray(valid), cell, table_size))


def _results_equal(rt: NNResult, rj):
    for f in ("idx", "dist_sq", "valid"):
        a, b = getattr(rt, f).numpy(), np.asarray(getattr(rj, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("cell,table_size", [(1.0, None), (2.0, None), (1.0, 1024), (0.5, 4096)])
def test_build_hash_grid_equals_jax(cell, table_size):
    pts, valid, _ = _cloud(1, 3500, 4096, spread=30.0)
    valid[::7] = False  # holes, not only trailing padding
    gt, gj = _grids(pts, valid, cell, table_size)
    for f in FIELDS:
        a, b = getattr(gt, f).numpy(), np.asarray(getattr(gj, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert gt.cell_size == gj.cell_size == cell
    assert gt.bucket_start.shape[0] == (table_size or 8192)
    assert int(gt.bucket_count.sum()) == int(valid.sum())
    # hash of cells far beyond int32 products: the JAX package's wrapped value
    cells = np.array([[2**20, -(2**20), 12345], [-7, 99999, -(2**24)]], np.int32)
    np.testing.assert_array_equal(hash_cells(torch.from_numpy(cells), 1 << 20).numpy(),
                                  np.asarray(jhash_cells(jnp.asarray(cells), 1 << 20)))


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("radius_sq", [None, 1.0])
def test_nn_search_equals_jax(k, radius_sq):
    pts, valid, queries = _cloud(2, 3500, 4096, spread=30.0, q=1000)
    qvalid = np.random.RandomState(3).rand(1000) > 0.1
    gt, gj = _grids(pts, valid, 1.0)
    rt = nn_search(gt, torch.from_numpy(queries), torch.from_numpy(qvalid), k=k,
                   max_radius_sq=radius_sq)
    rj = jnn_search(gj, jnp.asarray(queries), jnp.asarray(qvalid), k=k,
                    max_radius_sq=radius_sq)
    _results_equal(rt, rj)
    assert rt.idx.shape == (1000, k) and bool(rt.valid.any())
    assert not bool(rt.valid[~torch.from_numpy(qvalid)].any())


def test_nn_search_keeps_the_duplicates_of_colliding_cells():
    """A table of 1024 buckets over a dense grid: two of a query's 27 cells
    often share a bucket, whose rows are then gathered twice; JAX's k=8
    result holds such a neighbour twice, and so does the port's."""
    rng = np.random.RandomState(4)
    pts = rng.uniform(-6, 6, (2048, 3)).astype(np.float32)
    valid = np.ones(2048, bool)
    queries = rng.uniform(-6, 6, (512, 3)).astype(np.float32)
    gt, gj = _grids(pts, valid, 1.0, table_size=1024)
    qc = cell_coords(torch.from_numpy(queries), 1.0)
    nh = hash_cells(qc[:, None, :] + torch.from_numpy(NEIGHBOR_OFFSETS).to(torch.int32), 1024)
    collide = torch.tensor([len(set(r.tolist())) < 27 for r in nh])
    assert int(collide.sum()) > 10  # the case is exercised
    rt = nn_search(gt, torch.from_numpy(queries), torch.ones(512, dtype=torch.bool), k=8,
                   k_per_cell=32)
    rj = jnn_search(gj, jnp.asarray(queries), jnp.ones(512, bool), k=8, k_per_cell=32)
    _results_equal(rt, rj)
    dup = torch.tensor([len(set(r.tolist())) < 8 for r in rt.idx])
    assert int(dup.sum()) > 0 and not bool((dup & ~collide).any())


def test_hash_grid_from_jax():
    pts, valid, queries = _cloud(5)
    gj = jbuild(jnp.asarray(pts), jnp.asarray(valid), 2.0)
    gt = convert.hash_grid_from_jax(gj)
    assert isinstance(gt, HashGrid) and gt.points_sorted.device.type == "cpu"
    for f in FIELDS:
        assert torch.equal(getattr(gt, f), getattr(build_hash_grid(
            torch.from_numpy(pts), torch.from_numpy(valid), 2.0), f)), f
    _results_equal(nn_search(gt, torch.from_numpy(queries), torch.ones(64, dtype=torch.bool)),
                   jnn_search(gj, jnp.asarray(queries), jnp.ones(64, bool)))


# ------------------------------------------ the JAX tests' envelope (test_nn.py)
def _brute_force(points, valid, queries, k=1):
    pts = np.where(valid[:, None], points, 1e9)
    d = ((queries[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d, idx, axis=1)


@pytest.mark.parametrize("k,radius,k_per_cell", [(1, 2.0, 32), (4, 3.0, 48)])
def test_nn_search_exact_within_radius(k, radius, k_per_cell):
    pts, valid, queries = _cloud()
    grid = build_hash_grid(torch.from_numpy(pts), torch.from_numpy(valid), radius)
    res = nn_search(grid, torch.from_numpy(queries), torch.ones(64, dtype=torch.bool), k=k,
                    k_per_cell=k_per_cell, max_radius_sq=radius * radius)
    bf_idx, bf_d = _brute_force(pts, valid, queries, k)
    inside = bf_d < radius * radius
    np.testing.assert_array_equal(res.valid.numpy(), inside)
    np.testing.assert_array_equal(res.idx.numpy()[inside], bf_idx[inside])
    np.testing.assert_allclose(res.dist_sq.numpy()[inside], bf_d[inside], rtol=1e-5)
    assert (res.idx.numpy()[~inside] == -1).all()


def test_nn_search_masks_invalid_queries_and_padding():
    pts, valid, queries = _cloud()
    grid = build_hash_grid(torch.from_numpy(pts), torch.from_numpy(valid), 1.0)
    res = nn_search(grid, torch.from_numpy(queries), torch.zeros(64, dtype=torch.bool))
    assert not bool(res.valid.any()) and bool((res.dist_sq == 3.0e37).all())
    far = nn_search(grid, torch.tensor([[1e8, 1e8, 1e8]]), torch.ones(1, dtype=torch.bool),
                    max_radius_sq=16.0)
    assert not bool(far.valid[0, 0]) and int(far.idx[0, 0]) == -1


def test_grid_equals_the_exact_knn_on_a_decimated_cloud():
    """TestGridVsBruteforceParity on the port: one point per 1 m voxel,
    cell 1 m, radius 1 m, k=1: the grid's valid rows and neighbours equal
    knn_bruteforce's, and so do the distances (both exact f32 (q - p)^2,
    added in the same order)."""
    rng = np.random.RandomState(42)
    cap = 2048
    raw = rng.uniform(-20, 20, (cap, 3)).astype(np.float32)
    cells = np.floor(raw / 1.0).astype(np.int64)
    _, first = np.unique(cells[:, 0] * 10_000_000 + cells[:, 1] * 1000 + cells[:, 2],
                         return_index=True)
    pvalid = np.zeros(cap, bool)
    pvalid[first[:1800]] = True
    pts = np.where(pvalid[:, None], raw, 1e8).astype(np.float32)
    queries = rng.uniform(-20, 20, (256, 3)).astype(np.float32)
    qvalid = torch.ones(256, dtype=torch.bool)
    grid = build_hash_grid(torch.from_numpy(pts), torch.from_numpy(pvalid), 1.0)
    rg = nn_search(grid, torch.from_numpy(queries), qvalid, k=1, k_per_cell=16,
                   max_radius_sq=1.0)
    rb = knn_bruteforce(torch.from_numpy(queries), qvalid, torch.from_numpy(pts),
                        torch.from_numpy(pvalid), k=1, max_radius_sq=1.0)
    assert torch.equal(rg.valid, rb.valid) and int(rb.valid.sum()) > 20
    m = rb.valid[:, 0]
    assert torch.equal(rg.idx[m], rb.idx[m])
    assert torch.equal(rg.dist_sq[m], rb.dist_sq[m])
