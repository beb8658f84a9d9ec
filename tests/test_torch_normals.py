"""Parity of the port's 3x3 eigen solver and normals fit with the JAX
package on the CPU.

- ``eigh3x3`` on random SPD, rank-1, rank-2 and isotropic matrices:
  eigenvalues to 1e-5 relative (to the largest), eigenvectors to 1e-4
  including their sign. Where two eigenvalues coincide (rank 1, a
  line-like neighbourhood) the closed form takes arccos next to +-1, which
  magnifies the last bit of its argument: each package is then 2.4e-4
  from the truth, they are held to 5e-4 of each other, and the vectors of
  the repeated eigenvalue are any basis of its eigenspace;
- ``estimate_points_eigen`` on shared neighbourhoods: the same, the
  tolerance chosen row by row from the gaps between the eigenvalues;
- ``estimate_point_normals`` on a street scan, end to end: >= 99% of the
  rows equal to 1e-3 on a thinned scan (>= 92% on a FirstPoint-decimated
  one, whose near-grid points tie far more often); the rest are explained by a kNN near-tie (the port's
  d² is exact, the JAX package's off by up to 2e-3 m²) that changes the
  last member of a neighbourhood, by a fit next to the planarity
  threshold, or by a line-like neighbourhood (one ring on the ground),
  whose normal is any vector across the line.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.ops import eigen as jeigen
from mp2p_icp_tpu.ops.nn_bruteforce import knn_bruteforce as jknn
from mp2p_icp_tpu.ops.normals import estimate_point_normals as jnormals
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.eval.lidar_sim import make_street_sequence
from mp2p_icp_tpu_torch.filters import FilterDecimateVoxels
from mp2p_icp_tpu_torch.ops import eigen
from mp2p_icp_tpu_torch.ops.normals import estimate_point_normals
from mp2p_icp_tpu_torch.parity import TIE_TOL


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


def _rotations(rng, n):
    q, _ = np.linalg.qr(rng.randn(n, 3, 3))
    return q


def _matrices(kind, n=500):
    """Symmetric matrices Q diag(l) Q^T with eigenvalues of the kind."""
    rng = np.random.RandomState(0)
    lam = {
        # separated by a factor >= 2, so that the eigenvectors are well
        # conditioned (their error grows with 1 / gap)
        "spd": np.sort(rng.uniform(0.5, 1.0, (n, 3)) * np.array([1.0, 4.0, 16.0]), axis=1),
        "rank1": np.stack([np.zeros(n), np.zeros(n), rng.uniform(0.5, 4.0, n)], 1),
        "rank2": np.stack([np.zeros(n), rng.uniform(0.5, 1.0, n), rng.uniform(2.0, 4.0, n)], 1),
        "isotropic": np.repeat(rng.uniform(0.5, 4.0, (n, 1)), 3, axis=1),
    }[kind]
    Q = _rotations(rng, n)
    return (Q * lam[:, None, :]) @ Q.transpose(0, 2, 1), lam


@pytest.mark.parametrize("kind", ["spd", "rank1", "rank2", "isotropic"])
def test_eigh3x3_matches_jax(kind):
    A, lam = _matrices(kind)
    A = A.astype(np.float32)
    ej, vj = jeigen.eigh3x3(jnp.asarray(A))
    et, vt = eigen.eigh3x3(torch.from_numpy(A))
    ej, vj, et, vt = np.asarray(ej), np.asarray(vj), et.numpy(), vt.numpy()
    scale = np.abs(lam).max(axis=1, keepdims=True)
    tol = 5e-4 if kind == "rank1" else 1e-5  # arccos next to 1: see the module's note
    assert (np.abs(et - ej) / scale).max() < tol  # values, relative
    assert (np.abs(et - lam) / scale).max() < max(tol, 1e-4)  # and right
    # vectors, sign included. Where an eigenvalue repeats, any vector of its
    # eigenspace is an eigenvector and the closed form's choice hangs on
    # rounding: there the packages must agree on the well-defined ones (the
    # normal of rank 2, the axis of rank 1), and on orthonormality
    if kind in ("spd", "rank2"):
        assert np.abs(vt - vj).max() < 1e-4
        resid = A @ vt - et[:, None, :] * vt
        assert np.abs(resid).max() < 1e-4 * scale.max()
    elif kind == "isotropic":
        np.testing.assert_array_equal(vt, vj)  # the same fallbacks
    for v in (vt, vj):
        np.testing.assert_allclose(v.transpose(0, 2, 1) @ v, np.broadcast_to(np.eye(3), v.shape),
                                   atol=1e-4)


def test_eigh3x3_batch_shapes():
    A, _ = _matrices("spd", 24)
    A = torch.from_numpy(A.astype(np.float32))
    e, v = eigen.eigh3x3(A.reshape(4, 6, 3, 3))
    e1, v1 = eigen.eigh3x3(A[5])
    assert e.shape == (4, 6, 3) and v.shape == (4, 6, 3, 3)
    assert torch.equal(e.reshape(24, 3)[5], e1) and torch.equal(v.reshape(24, 3, 3)[5], v1)


def test_estimate_points_eigen_on_shared_neighbourhoods():
    """Planar, linear and scattered 8-point neighbourhoods with a random
    mask (float weights too): the same inputs to both packages."""
    rng = np.random.RandomState(1)
    n = 600
    base = rng.uniform(-60, 60, (n, 1, 3))
    spread = rng.randn(n, 8, 3) * np.where(np.arange(n)[:, None, None] % 3 == 0,
                                           [1.0, 1.0, 0.01],  # planes
                                           np.where(np.arange(n)[:, None, None] % 3 == 1,
                                                    [1.0, 0.01, 0.01], [1.0, 0.7, 0.5]))
    pts = (base + np.einsum("nij,nkj->nki", _rotations(rng, n), spread)).astype(np.float32)
    mask = rng.rand(n, 8) > 0.2
    for m in (mask, mask * rng.uniform(0.5, 1.0, (n, 8)).astype(np.float32)):
        pj = jeigen.estimate_points_eigen(jnp.asarray(pts), jnp.asarray(m))
        pt = eigen.estimate_points_eigen(torch.from_numpy(pts), torch.from_numpy(m))
        np.testing.assert_array_equal(pt.count.numpy(), np.asarray(pj.count))
        np.testing.assert_allclose(pt.mean.numpy(), np.asarray(pj.mean), atol=1e-5)
        ev = np.asarray(pj.eigenvalues)
        rel = (np.abs(pt.eigenvalues.numpy() - ev) / ev[:, 2:]).max(axis=1)
        # two eigenvalues within a tenth of the largest: arccos next to +-1
        close = np.minimum(ev[:, 1] - ev[:, 0], ev[:, 2] - ev[:, 1]) < 0.1 * ev[:, 2]
        assert 0.2 < close.mean() < 0.9
        assert rel[~close].max() < 1e-5 and rel[close].max() < 5e-4, (
            rel[~close].max(), rel[close].max())
        # the normal (the eigenvector of l0) of the plane-like third, sign included
        planes = (np.arange(n) % 3 == 0) & (mask.sum(1) >= 4)
        gap = np.abs(pt.eigenvectors.numpy()[planes, :, 0] - np.asarray(pj.eigenvectors)[planes, :, 0])
        # an eigenvalue off by 5e-4 of l2 turns its vector by about as much
        sep = ~close[planes]
        assert gap[sep].max() < 1e-4 and gap[~sep].max() < 5e-3, (gap[sep].max(), gap[~sep].max())


@pytest.fixture(scope="module", params=["every_6th_return", "first_point_0.5m"])
def street_cloud(request):
    """(JAX cloud, port cloud, share of rows allowed to differ)."""
    _, _, scans = make_street_sequence(2, n_rings=32, n_azimuth=512)
    xyz = scans[0]["xyz"][scans[0]["valid"]]
    if request.param == "every_6th_return":
        # ~2700 points at +-60 m. A stride that divides the 512 azimuths (4,
        # 8) lines the columns up across the rings; unthinned, the 8 nearest
        # points lie along one ring and the fit is a line
        xyz, share = xyz[::6], 0.01
    else:
        # the seed's own case: the scan after FirstPoint decimation. Its
        # points sit one per voxel, near a grid, so many 8th and 9th
        # neighbours are within the JAX kNN's rounding band of each other
        # and 4.5% of the fits see another neighbourhood (measured; 8% allowed)
        dec = FilterDecimateVoxels(voxel_filter_resolution=0.5, output_capacity=4096)(
            {"raw": PointCloud.from_numpy(xyz, capacity=1 << 14)})["decimated"]
        xyz, share = dec.xyz.numpy()[: int(dec.count)], 0.08
    pj = JPointCloud.from_numpy(xyz, capacity=4096)
    return pj, convert.pointcloud_from_jax(pj), share


@pytest.mark.parametrize("with_source", [False, True])
def test_estimate_point_normals_on_a_street_scan(street_cloud, with_source):
    pj, pt, share = street_cloud
    kwargs = dict(knn=8, max_radius=1.5, plane_eigen_threshold=1e-2)
    if with_source:
        # queries: a compacted block of rows; candidates: the whole scan with
        # an explicit validity mask, as the odometry step calls it
        n = int(pj.count)
        qj = JPointCloud.from_numpy(np.asarray(pj.xyz)[100:900], capacity=1024)
        qt = convert.pointcloud_from_jax(qj)
        sv = np.arange(4096) < n
        sv[::7] = False
        oj = jnormals(qj, source=pj, source_valid=jnp.asarray(sv), **kwargs)
        ot = estimate_point_normals(qt, source=pt, source_valid=torch.from_numpy(sv), **kwargs)
        q_xyz, n_q = np.asarray(qj.xyz), 800
    else:
        oj, ot = jnormals(pj, **kwargs), estimate_point_normals(pt, **kwargs)
        sv, q_xyz, n_q = np.asarray(pj.valid_mask()), np.asarray(pj.xyz), int(pj.count)
    nj, nt = np.asarray(oj.normals), ot.normals.numpy()
    assert nt.shape == nj.shape and (nt[n_q:] == 0).all()
    np.testing.assert_array_equal(ot.xyz.numpy(), np.asarray(oj.xyz))
    differ = np.abs(nt - nj).max(axis=1) > 1e-3
    assert differ[:n_q].mean() <= share, differ[:n_q].mean()  # the rows not equal to 1e-3
    fitted = (np.abs(nt[:n_q]).sum(1) > 0).mean()
    assert 0.2 < fitted <= 1.0
    np.testing.assert_allclose(np.linalg.norm(nt[np.abs(nt).sum(1) > 0], axis=1), 1.0, atol=1e-4)

    # the rest, by cause: the JAX kNN's 8th and 9th neighbours within its
    # rounding band of each other (another last member), or l0 / l2 within
    # 10% of the planarity threshold in the JAX fit
    rows = np.nonzero(differ)[0]
    if len(rows):
        src = np.asarray(pj.xyz)
        res = jknn(jnp.asarray(q_xyz[rows]), jnp.ones(len(rows), bool), jnp.asarray(src),
                   jnp.asarray(sv), k=8, max_radius_sq=1.5**2)
        d = np.sort(((q_xyz[rows, None, :].astype(np.float64) - src[None, sv, :]) ** 2).sum(-1), 1)
        near_tie = np.abs(d[:, 8] - d[:, 7]) <= TIE_TOL
        at_radius = np.abs(d[:, :9] - 1.5**2).min(axis=1) <= TIE_TOL
        pe = jeigen.estimate_points_eigen(
            jnp.asarray(src)[jnp.clip(res.idx, 0, 4095)], res.valid)
        ratio = np.asarray(pe.eigenvalues[:, 0] / pe.eigenvalues[:, 2])
        at_threshold = np.abs(ratio - 1e-2) <= 1e-3
        line_like = np.asarray(pe.eigenvalues[:, 1] / pe.eigenvalues[:, 2]) < 1e-2
        explained = near_tie | at_radius | at_threshold | line_like
        assert explained.all(), rows[~explained]
