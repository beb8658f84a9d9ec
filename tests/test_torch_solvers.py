"""Parity of the port's solvers and covariance with the JAX package on the
CPU: identical Pairings (all five blocks, built from numpy) go through Horn
(with the pt2pl/pt2ln conversion), Gauss-Newton (plain and GemanMcClure,
with and without an SE3Prior) and the covariance.

Tolerances: poses to 1e-5 (f32 on both sides; only the order of the sums
over the pairs differs); covariance to a relative 1e-4 of its largest
entry (the inverse of a well-conditioned 6x6 normal matrix).
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu import covariance as jcov
from mp2p_icp_tpu.core import pairings as jp
from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.solvers import gauss_newton as jgn
from mp2p_icp_tpu.solvers import olae as jolae
from mp2p_icp_tpu.solvers import solver as jsolver
from mp2p_icp_tpu.solvers.common import WeightParameters as JWeightParameters
from mp2p_icp_tpu.solvers.robust import RobustKernel as JRobustKernel
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch import covariance as tcov
from mp2p_icp_tpu_torch.core import pairings as tp
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.solvers import common as tcommon
from mp2p_icp_tpu_torch.solvers import gauss_newton as tgn
from mp2p_icp_tpu_torch.solvers import olae as tolae
from mp2p_icp_tpu_torch.solvers import solver as tsolver
from mp2p_icp_tpu_torch.solvers.common import WeightParameters
from mp2p_icp_tpu_torch.solvers.robust import RobustKernel


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


POSE_ATOL = 1e-5


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _pairings_np(seed, n=600, n_pl=200, n_ln=100, n_small=8, noise=0.02):
    """Numpy fields of all five blocks for a known motion (rows with zero
    weight included, as the matchers emit them)."""
    rng = np.random.RandomState(seed)
    T = jse3.exp(jnp.asarray(np.r_[rng.uniform(-1, 1, 3), rng.uniform(-0.1, 0.1, 3)],
                             dtype=jnp.float32))
    R, t = np.asarray(T.R, np.float64), np.asarray(T.t, np.float64)

    def fwd(x):
        return x @ R.T + t

    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    local = rng.uniform(-30, 30, (n, 3))
    w = (rng.rand(n) > 0.1).astype(np.float32)
    pt2pt = dict(local=f32(local), globl=f32(fwd(local) + noise * rng.randn(n, 3)),
                 weight=w, local_idx=np.where(w > 0, np.arange(n), -1).astype(np.int32),
                 global_idx=np.where(w > 0, np.arange(n), -1).astype(np.int32))
    lp = rng.uniform(-30, 30, (n_pl, 3))
    nrm = _unit(rng.randn(n_pl, 3))
    wpl = (rng.rand(n_pl) > 0.1).astype(np.float32)
    pt2pl = dict(local=f32(lp), plane_centroid=f32(fwd(lp) + rng.randn(n_pl, 3) * 0.5
                                                    - nrm * (0.02 * rng.randn(n_pl, 1))),
                 plane_normal=f32(nrm), weight=wpl,
                 local_idx=np.arange(n_pl, dtype=np.int32))
    ll = rng.uniform(-30, 30, (n_ln, 3))
    d = _unit(rng.randn(n_ln, 3))
    pt2ln = dict(local=f32(ll), line_point=f32(fwd(ll) + d * rng.randn(n_ln, 1)),
                 line_dir=f32(d), weight=np.ones(n_ln, np.float32),
                 local_idx=np.arange(n_ln, dtype=np.int32))
    ld = _unit(rng.randn(n_small, 3))
    lpt = rng.uniform(-5, 5, (n_small, 3))
    ln2ln = dict(local_point=f32(lpt), local_dir=f32(ld), global_point=f32(fwd(lpt)),
                 global_dir=f32(ld @ R.T), weight=np.ones(n_small, np.float32))
    ln_ = _unit(rng.randn(n_small, 3))
    pl2pl = dict(local_normal=f32(ln_), local_centroid=f32(lpt), global_normal=f32(ln_ @ R.T),
                 global_centroid=f32(fwd(lpt)), weight=np.ones(n_small, np.float32))
    return dict(pt2pt=pt2pt, pt2pl=pt2pl, pt2ln=pt2ln, ln2ln=ln2ln, pl2pl=pl2pl,
                potential_pairings=np.int32(n + n_pl + n_ln))


def _both(fields, keep=("pt2pt", "pt2pl", "pt2ln", "ln2ln", "pl2pl")):
    """The same pairings as a JAX and a port Pairings (blocks not in
    ``keep`` are one empty row)."""
    jcls = dict(pt2pt=jp.PairsPt2Pt, pt2pl=jp.PairsPt2Pl, pt2ln=jp.PairsPt2Ln,
                ln2ln=jp.PairsLn2Ln, pl2pl=jp.PairsPl2Pl)
    jb, tb = {}, {}
    for name, cls in jcls.items():
        if name in keep:
            jb[name] = cls(**{k: jnp.asarray(v) for k, v in fields[name].items()})
            tb[name] = tp.BLOCK_TYPES[name](
                **{k: torch.from_numpy(np.array(v)) for k, v in fields[name].items()})
        else:
            jb[name] = cls.empty(1)
            tb[name] = tp.BLOCK_TYPES[name].empty(1)
    pot = fields["potential_pairings"]
    return (jp.Pairings(**jb, potential_pairings=jnp.asarray(pot)),
            tp.Pairings(**tb, potential_pairings=torch.tensor(int(pot), dtype=torch.int32)))


def _guess(seed):
    rng = np.random.RandomState(100 + seed)
    xi = np.r_[rng.uniform(-0.2, 0.2, 3), rng.uniform(-0.02, 0.02, 3)].astype(np.float32)
    pj = jse3.exp(jnp.asarray(xi))
    return pj, convert.pose_from_numpy(np.asarray(pj.R), np.asarray(pj.t))


def _close_pose(pt, pj, atol=POSE_ATOL):
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=atol, rtol=0)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=atol, rtol=0)


@pytest.mark.parametrize("seed,wp", [
    (0, {}),
    (1, {}),
    (0, dict(use_scale_outlier_detector=True)),
    (1, dict(robust_kernel="GemanMcClure", robust_kernel_param=0.5)),
])
def test_horn_matches_jax(seed, wp):
    fields = _pairings_np(seed)
    pj, pt = _both(fields)
    gj, gt = _guess(seed)
    jw = dict(wp)
    tw = dict(wp)
    if "robust_kernel" in wp:
        jw["robust_kernel"] = JRobustKernel.from_string(wp["robust_kernel"])
        tw["robust_kernel"] = RobustKernel.from_string(wp["robust_kernel"])
    sj = jsolver.SolverHorn(weight_params=JWeightParameters(**jw))
    st = tsolver.SolverHorn(weight_params=WeightParameters(**tw))
    out_j = sj.solve(pj, gj)
    out_t = st.solve(pt, gt)
    _close_pose(out_t, out_j)


@pytest.mark.parametrize("kernel,prior", [
    ("None", False), ("GemanMcClure", False), ("None", True), ("GemanMcClure", True),
])
def test_gauss_newton_matches_jax(kernel, prior):
    fields = _pairings_np(7)
    pj, pt = _both(fields)
    gj, gt = _guess(7)
    params_j = jgn.GNParams(max_iterations=3, kernel=JRobustKernel.from_string(kernel),
                            kernel_param=0.15)
    name, cfg = convert.config_of(jsolver.SolverGaussNewton(gn_params=params_j))
    st = convert.solver_from_config(name, cfg)
    assert st.gn_params.kernel == RobustKernel.from_string(kernel)
    prior_j = prior_t = None
    if prior:
        info = np.diag([10.0, 10.0, 10.0, 100.0, 100.0, 100.0]).astype(np.float32)
        prior_j = jgn.SE3Prior(mean=gj, inv_cov=jnp.asarray(info))
        prior_t = tgn.SE3Prior(mean=gt, inv_cov=torch.from_numpy(info))
    out_j = jsolver.SolverGaussNewton(gn_params=params_j).solve(pj, gj, prior_j)
    out_t = st.solve(pt, gt, prior_t)
    _close_pose(out_t, out_j)
    # the normal equations themselves, at the guess
    Hj, g_j, ej = jgn.gn_build_normal_equations(gj, pj, params_j, prior_j)
    Ht, g_t, et = tgn.gn_build_normal_equations(gt, pt, st.gn_params, prior_t)
    scale = np.abs(np.asarray(Hj)).max()
    np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j),
                               atol=1e-5 * np.abs(np.asarray(g_j)).max(), rtol=0)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-4)


@pytest.mark.parametrize("keep", [
    ("pt2pt", "pt2pl", "pt2ln", "ln2ln", "pl2pl"),
    ("pt2pt",),
    (),
])
def test_covariance_matches_jax(keep):
    fields = _pairings_np(3)
    if not keep:  # no pairings at all: the 1e6 fallback
        fields = {k: (dict(v, weight=np.zeros_like(v["weight"])) if isinstance(v, dict) else v)
                  for k, v in fields.items()}
    pj, pt = _both(fields, keep=keep or ("pt2pt",))
    gj, gt = _guess(3)
    cj = np.asarray(jcov.covariance(pj, gj))
    ct = tcov.covariance(pt, gt).numpy()
    np.testing.assert_allclose(ct, cj, atol=1e-4 * np.abs(cj).max(), rtol=0)


def test_gn_solve_normal_equations_singular_gives_no_step():
    # rank-deficient H: the JAX Cholesky gives NaN, the step is zeroed
    H = torch.zeros(6, 6)
    g = torch.ones(6)
    delta = tgn.solve_normal_equations(H, g)
    Hj = jgn.solve_normal_equations(jnp.zeros((6, 6)), jnp.ones(6))
    assert np.isnan(np.asarray(Hj)).all() == torch.isnan(delta).all().item()


def test_solver_gates_and_unported_options():
    s = tsolver.SolverHorn(run_from_iteration=2, run_up_to_iteration=4)
    assert [s.gate(i) for i in range(6)] == [False, False, True, True, True, False]
    assert not dataclasses.replace(s, enabled=False).gate(3)
    # scale estimation and OLAE are ported (test_torch_engine_options.py,
    # test_olae_matches_jax); an unknown solver still raises
    assert tsolver.SolverHorn(estimate_scale=True).estimate_scale
    olae = convert.solver_from_config("SolverOLAE", dataclasses.asdict(tsolver.SolverOLAE()))
    assert isinstance(olae, tsolver.SolverOLAE)
    with pytest.raises(NotImplementedError):
        convert.solver_from_config("SolverLevenbergMarquardt", {})


@pytest.mark.parametrize("name,block", [
    ("error_point2point", ("pt2pt", ["local", "globl"])),
    ("error_point2line", ("pt2ln", ["local", "line_point", "line_dir"])),
    ("error_point2plane", ("pt2pl", ["local", "plane_centroid", "plane_normal"])),
    ("error_line2line", ("ln2ln", ["local_point", "local_dir", "global_point", "global_dir"])),
    ("error_plane2plane", ("pl2pl", ["local_normal", "global_normal"])),
])
def test_error_terms_match_jax(name, block):
    """Residuals and analytic Jacobians of all five pairing types (the
    normal equations read them all); atol 1e-4 at |x| <= 30 m."""
    from mp2p_icp_tpu.solvers import error_terms as jet
    from mp2p_icp_tpu_torch.solvers import error_terms as tet

    fields = _pairings_np(11)[block[0]]
    args = [fields[k] for k in block[1]]
    gj, gt = _guess(11)
    rj, Jj = getattr(jet, name)(gj, *(jnp.asarray(a) for a in args))
    rt, Jt = getattr(tet, name)(gt, *(torch.from_numpy(np.array(a)) for a in args))
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-4, rtol=0)


@pytest.mark.parametrize("seed,wp", [
    (0, {}),
    (1, {}),
    (2, dict(robust_kernel="GemanMcClure", robust_kernel_param=0.5)),
])
def test_olae_matches_jax(seed, wp):
    """SolverOLAE on all five blocks (pt2pl / pt2ln converted), against
    the JAX package's at 1e-5."""
    fields = _pairings_np(seed)
    pj, pt = _both(fields)
    gj, gt = _guess(seed)
    jw, tw = dict(wp), dict(wp)
    if "robust_kernel" in wp:
        jw["robust_kernel"] = JRobustKernel.from_string(wp["robust_kernel"])
        tw["robust_kernel"] = RobustKernel.from_string(wp["robust_kernel"])
    out_j = jsolver.SolverOLAE(weight_params=JWeightParameters(**jw)).solve(pj, gj)
    name, cfg = convert.config_of(jsolver.SolverOLAE(weight_params=JWeightParameters(**jw)))
    st = convert.solver_from_config(name, cfg)
    assert st == tsolver.SolverOLAE(weight_params=WeightParameters(**tw))
    _close_pose(st.solve(pt, gt), out_j)


@pytest.mark.parametrize("seed", range(4))
def test_olae_large_rotation_near_pi(seed):
    """tests/test_optimal_tf.py::TestOLAE::test_large_rotation_near_pi: at
    a rotation of π - 0.01 the Gibbs vector of the plain system is
    singular and a sequential-rotation alternate must win, in both
    packages alike (1e-5), both within 2e-3 of the truth."""
    axis = np.asarray(jax.random.normal(jax.random.key(seed + 500), (3,)))
    axis = axis / np.linalg.norm(axis)
    gt = jse3.Pose(jse3.so3_exp(jnp.asarray(axis * (np.pi - 0.01))), jnp.array([1.0, -2.0, 0.5]))
    rng = np.random.RandomState(seed)
    n, cap = 60, 128
    local = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    globl = np.asarray(jse3.apply(gt, jnp.asarray(local)))
    pad = np.zeros((cap - n, 3), np.float32)
    fields = dict(_pairings_np(seed), pt2pt=dict(
        local=np.concatenate([local, pad]), globl=np.concatenate([globl, pad]),
        weight=np.r_[np.ones(n), np.zeros(cap - n)].astype(np.float32),
        local_idx=np.arange(cap, dtype=np.int32), global_idx=np.arange(cap, dtype=np.int32)))
    pj, pt = _both(fields, keep=("pt2pt",))
    out_j = jolae.optimal_tf_olae(pj)
    out_t = tsolver.solve_in_f64(lambda p, g, pr: tolae.optimal_tf_olae(p), pt, se3.identity())
    _close_pose(out_t, out_j)
    gt_t = convert.pose_from_numpy(np.asarray(gt.R), np.asarray(gt.t))
    assert float(se3.error_log_norm(gt_t, out_t)) < 2e-3
    Ms, _ = tolae.olae_systems(tcommon.build_vector_pairs(
        tsolver.f64(pt), WeightParameters(), normalize_point_vectors=True))
    assert int(torch.argmax(torch.abs(torch.linalg.det(Ms)))) != 0  # an alternate won


def test_gn_reference_file_is_the_jax_package_s():
    """scripts/torch_gn_reference.json, the JAX package's poses that the
    Gauss-Newton kernel's card test (tests/test_torch_gn_kernel.py, which
    imports no JAX) holds the kernel to, is what the JAX package computes
    on those inputs here (within 1e-6 relative: a few float32 ulps)."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import torch_gn_reference as gref

    ref = json.loads(gref.REFERENCE.read_text())
    assert ref["params"] == gref.PARAMS
    assert [(c["n_pt"], c["n_pl"], c["seed"]) for c in ref["cases"]] == [
        (*shape, seed) for shape in gref.SHAPES for seed in gref.SEEDS]
    for c in ref["cases"]:
        R, t = gref.jax_pose(c["n_pt"], c["n_pl"], c["seed"])
        np.testing.assert_allclose(R.ravel(), c["R"], rtol=1e-6, atol=0)
        np.testing.assert_allclose(t, c["t"], rtol=1e-6, atol=0)
