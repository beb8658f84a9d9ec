"""Parity of the port's kNN front end and one-to-one resolver with the JAX
package, on the CPU (where the port's sweep is ``knn_plain``).

The JAX kNN runs both ways its own tests run it on the CPU: the Pallas
kernel in interpret mode and the XLA path. Comparison is tie-tolerant
(``mp2p_icp_tpu_torch.parity``): the true d² of the port's neighbour must
lie within 2e-3 m² of the true d² of the reference's neighbour at the same
rank, and validity may differ only within that band of the radius. The
band is the reference's own: its |p|² - 2q·p + |q|² distances are off by up
to ~2.4e-3 m² at these coordinates (measured on these cases), so a
neighbour closer than that to the runner-up may come back either way.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu.ops import nn as jnn
from mp2p_icp_tpu.ops import nn_bruteforce as jnb
from mp2p_icp_tpu_torch.ops import nn as tnn
from mp2p_icp_tpu_torch.ops import nn_bruteforce as tnb
from mp2p_icp_tpu_torch.parity import TIE_TOL, knn_mismatch, true_dist_sq


def _problem(Q, C, seed, extent=60.0):
    rng = np.random.RandomState(seed)
    q = rng.uniform(-extent, extent, (Q, 3)).astype(np.float32)
    p = rng.uniform(-extent, extent, (C, 3)).astype(np.float32)
    # half of the queries sit near a point, as in a registration
    near = rng.rand(Q) < 0.5
    q[near] = p[rng.randint(0, C, near.sum())] + 0.3 * rng.randn(near.sum(), 3)
    qv = rng.rand(Q) > 0.1
    pv = rng.rand(C) > 0.1
    return q, qv, p, pv, rng


def _port(q, qv, p, pv, k, radius):
    r = None if radius is None else torch.as_tensor(radius)
    return tnb.knn_bruteforce(
        torch.from_numpy(q), torch.from_numpy(qv), torch.from_numpy(p),
        torch.from_numpy(pv), k=k, max_radius_sq=r,
    )


# (Q, C, k, radius kind): ragged sizes, every k class, both radius forms
CASES = [
    (300, 1000, 1, "scalar"),
    (777, 3001, 4, "per_query"),
    (777, 3001, 8, None),
    (777, 3001, 1, "per_query"),
]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("Q,C,k,radius", CASES)
def test_knn_matches_jax(backend, Q, C, k, radius):
    q, qv, p, pv, rng = _problem(Q, C, seed=Q + C + k)
    if radius == "scalar":
        r = np.float32(4.0)
    elif radius == "per_query":
        r = rng.uniform(0.5, 50.0, Q).astype(np.float32)
    else:
        r = None
    ref = jnb.knn_bruteforce(
        jnp.asarray(q), jnp.asarray(qv), jnp.asarray(p), jnp.asarray(pv), k=k,
        max_radius_sq=None if r is None else jnp.asarray(r),
        backend=backend, interpret=backend == "pallas",
    )
    res = _port(q, qv, p, pv, k, r)
    idx, valid = res.idx.numpy(), res.valid.numpy()
    bad = knn_mismatch(q, p, idx, valid, np.asarray(ref.idx),
                       np.asarray(ref.dist_sq), np.asarray(ref.valid), radius_sq=r)
    assert not bad.any(), f"{bad.sum()} entries disagree beyond ties"
    # contracts: int32 indices, -1 / 3e37 where invalid, no invalid query
    # or point ever paired, d2 exact in f32 (1e-4 relative to the f64 value)
    assert res.idx.dtype == torch.int32 and res.dist_sq.dtype == torch.float32
    assert (idx[~valid] == -1).all() and (res.dist_sq.numpy()[~valid] == 3.0e37).all()
    assert not valid[~qv].any()
    assert pv[idx[valid]].all()
    d_true = true_dist_sq(q, p, idx)[valid]
    np.testing.assert_allclose(res.dist_sq.numpy()[valid], d_true, rtol=1e-4, atol=1e-5)
    # ascending per row
    d = res.dist_sq.numpy()
    assert (np.diff(d, axis=1) >= 0).all()


def test_knn_plain_tie_break_lowest_index():
    # exact duplicates of one point: the lowest index must come first
    p = np.zeros((10, 3), np.float32)
    p[3:7] = 1.0
    q = np.ones((2, 3), np.float32)
    d, idx = tnb.knn_plain(torch.from_numpy(q), torch.from_numpy(p), 3)
    assert idx.tolist() == [[3, 4, 5], [3, 4, 5]]
    assert (d == 0).all()


def test_knn_plain_fewer_points_than_k():
    q = torch.zeros(4, 3)
    p = torch.ones(2, 3)
    d, idx = tnb.knn_plain(q, p, 5)
    assert idx[:, 2:].eq(-1).all() and torch.isinf(d[:, 2:]).all()
    res = tnb.knn_bruteforce(q, torch.ones(4, dtype=torch.bool), p,
                             torch.ones(2, dtype=torch.bool), k=5)
    assert res.valid.sum().item() == 8
    assert (res.idx[:, 2:] == -1).all()


def test_knn_sweep_checks_arguments():
    q = torch.zeros(4, 3)
    with pytest.raises(ValueError):
        tnb.knn_sweep(q, q, 9)
    with pytest.raises(ValueError):
        tnb.knn_sweep(q.double(), q.double(), 1)
    with pytest.raises(NotImplementedError):
        tnb.knn_bruteforce(q, torch.ones(4, dtype=torch.bool), q,
                           torch.ones(4, dtype=torch.bool), spatial_axis="space")


def test_knn_cpu_path_does_not_count_launches():
    before = tnb.knn_sweep.launches
    tnb.knn_sweep(torch.zeros(4, 3), torch.ones(5, 3), 2)
    assert tnb.knn_sweep.launches == before


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resolve_one_to_one_matches_jax(seed):
    rng = np.random.RandomState(seed)
    Q, G = 500, 60
    idx = rng.randint(0, G, (Q, 1)).astype(np.int32)
    # coarse distances force many exact ties: the lowest row must win them
    d = rng.randint(0, 5, (Q, 1)).astype(np.float32) * 0.25
    valid = rng.rand(Q, 1) > 0.2
    ref = jnn.resolve_one_to_one(jnp.asarray(idx), jnp.asarray(d), jnp.asarray(valid), G)
    got = tnn.resolve_one_to_one(torch.from_numpy(idx), torch.from_numpy(d),
                                 torch.from_numpy(valid), G)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8])
def test_kernel_matches_knn_plain_on_card(k):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kNN kernel has no CPU mode")
    q, qv, p, pv, _ = _problem(777, 3001, seed=k)
    qd, pd = torch.from_numpy(q).cuda(), torch.from_numpy(p).cuda()
    d_ref, i_ref = tnb.knn_plain(qd, pd, k)
    d, i = tnb.knn_sweep(qd, pd, k)
    torch.cuda.synchronize()
    ok = np.ones((777, k), bool)
    bad = knn_mismatch(q, p, i.cpu().numpy(), ok, i_ref.cpu().numpy(),
                       d_ref.cpu().numpy(), ok, tol=TIE_TOL)
    assert not bad.any()
    # direct (q - p)² with the same rounding: equal to the plain version
    assert torch.equal(d, d_ref)
