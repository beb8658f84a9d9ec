"""Parity of the port's core types with the JAX package, on the CPU:
SE(3) math (including angles near 0 and near π), the padded PointCloud,
pairings, the default device of the constructors, and the package's promise
never to import jax.

SE(3) tolerance: atol 1e-5 — both sides are f32 with the same formulas;
the libraries' sin/cos/arccos differ in the last ulp, which the near-π
branch amplifies to a few 1e-7.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import pairings as tpairings
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud, round_capacity


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


ATOL = 1e-5


def _tangents(angle, n=16, seed=0):
    """[n, 6] tangents whose rotation angle is ``angle`` (random axes and
    translations)."""
    rng = np.random.RandomState(seed)
    axis = rng.randn(n, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    rho = rng.uniform(-3, 3, (n, 3))
    return np.concatenate([rho, axis * angle], axis=1).astype(np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


ANGLES = [0.0, 1e-6, 1e-3, 0.5, 2.0, np.pi - 1e-3, np.pi - 1e-5]


@pytest.mark.parametrize("angle", ANGLES)
def test_exp_log_match_jax(angle):
    xi = _tangents(angle)
    pj = jse3.exp(jnp.asarray(xi))
    pt = se3.exp(torch.from_numpy(xi))
    _close(pt.R, pj.R)
    _close(pt.t, pj.t)
    # log of the SAME rotation on both sides (near π the axis sign is a
    # branch choice that must follow the reference's)
    R = np.array(pj.R)
    t = np.array(pj.t)
    lj = jse3.log(jse3.Pose(jnp.asarray(R), jnp.asarray(t)))
    lt = se3.log(se3.Pose(torch.from_numpy(R), torch.from_numpy(t)))
    _close(lt, lj)


@pytest.mark.parametrize("angle", [0.0, 0.3, np.pi - 1e-4])
def test_quaternions_match_jax(angle):
    R = np.array(jse3.exp(jnp.asarray(_tangents(angle, seed=1))).R)
    qj = jse3.rot_to_quat(jnp.asarray(R))
    qt = se3.rot_to_quat(torch.from_numpy(R))
    _close(qt, qj)
    _close(se3.quat_to_rot(qt), jse3.quat_to_rot(qj))


def test_compose_inverse_apply_rotate_match_jax():
    a = _tangents(0.7, n=4, seed=2)
    b = _tangents(2.5, n=4, seed=3)
    pa, pb = jse3.exp(jnp.asarray(a)), jse3.exp(jnp.asarray(b))
    ta, tb = se3.exp(torch.from_numpy(a)), se3.exp(torch.from_numpy(b))
    _close(se3.compose(ta, tb).R, jse3.compose(pa, pb).R)
    _close(se3.compose(ta, tb).t, jse3.compose(pa, pb).t, atol=3e-5)
    _close(se3.inverse(ta).t, jse3.inverse(pa).t)
    pts = np.random.RandomState(4).uniform(-60, 60, (4, 50, 3)).astype(np.float32)
    # |x| ~ 100 m: f32 rounding of R x + t is ~1e-5 relative -> 5e-5 m
    _close(se3.apply(ta, torch.from_numpy(pts)), jse3.apply(pa, jnp.asarray(pts)), atol=5e-5)
    _close(se3.rotate(ta, torch.from_numpy(pts)), jse3.rotate(pa, jnp.asarray(pts)), atol=5e-5)
    # a single point [3] against a single pose
    p1 = se3.Pose(ta.R[0], ta.t[0])
    j1 = jse3.Pose(pa.R[0], pa.t[0])
    _close(se3.apply(p1, torch.from_numpy(pts[0, 0])), jse3.apply(j1, jnp.asarray(pts[0, 0])), atol=5e-5)


def test_ypr_delta_norms_error_log_norm_match_jax():
    args = (1.1, 0.05, 0.01, 0.01, 0.002, 0.001)
    gj, gt = jse3.from_xyz_ypr(*args), se3.from_xyz_ypr(*args)
    _close(gt.R, gj.R)
    _close(gt.t, gj.t)
    est = _tangents(0.01, n=1, seed=5)[0] * 0.1
    ej, et = jse3.exp(jnp.asarray(est)), se3.exp(torch.from_numpy(est))
    for a, b in zip(se3.delta_norms(gt, et), jse3.delta_norms(gj, ej)):
        _close(a, b)
    _close(se3.error_log_norm(gt, et), jse3.error_log_norm(gj, ej))
    _close(se3.hat(torch.from_numpy(est[:3])), jse3.hat(jnp.asarray(est[:3])))
    _close(se3.vee(se3.hat(torch.from_numpy(est[:3]))), est[:3])


def test_se3_right_jacobian_inv_matches_jax():
    xi = _tangents(0.4, n=3, seed=6)
    _close(se3.se3_right_jacobian_inv(torch.from_numpy(xi)),
           jse3.se3_right_jacobian_inv(jnp.asarray(xi)))


@pytest.mark.parametrize("n,capacity", [(300, None), (1000, 4096), (256, None)])
def test_pointcloud_padding_matches_jax(n, capacity):
    xyz = np.random.RandomState(n).uniform(-10, 10, (n, 3)).astype(np.float32)
    pj = JPointCloud.from_numpy(xyz, capacity=capacity)
    pt = PointCloud.from_numpy(xyz, capacity=capacity)
    assert pt.capacity == pj.capacity == (capacity or round_capacity(n))
    np.testing.assert_array_equal(pt.xyz.numpy(), np.asarray(pj.xyz))
    assert int(pt.count) == int(pj.count) == n
    assert pt.count.dtype == torch.int32
    np.testing.assert_array_equal(pt.valid_mask().numpy(), np.asarray(pj.valid_mask()))
    np.testing.assert_array_equal(pt.to_numpy(), xyz)


def test_pointcloud_transformed_keeps_padding_at_sentinel():
    xyz = np.random.RandomState(0).uniform(-10, 10, (100, 3)).astype(np.float32)
    pose = se3.exp(torch.from_numpy(_tangents(1.0, n=1)[0]))
    pt = PointCloud.from_numpy(xyz).transformed(pose)
    assert (pt.xyz[100:] == PointCloud.PAD_VALUE).all()
    pj = JPointCloud.from_numpy(xyz).transformed(
        jse3.Pose(jnp.asarray(pose.R.numpy()), jnp.asarray(pose.t.numpy()))
    )
    _close(pt.xyz[:100], np.asarray(pj.xyz)[:100], atol=5e-5)


def test_pointcloud_rejects_small_capacity_and_bad_channels():
    with pytest.raises(ValueError):
        PointCloud.from_numpy(np.zeros((10, 3)), capacity=4)
    with pytest.raises(ValueError):
        PointCloud.from_numpy(np.zeros((10, 3)), intensity=np.zeros(3))


def test_pairings_empty_and_size():
    p = tpairings.Pairings.empty(pt2pt_cap=5, pt2pl_cap=3)
    assert p.pt2pt.capacity == 5 and p.pt2pl.capacity == 3 and p.pt2ln.capacity == 1
    assert (p.pt2pt.local_idx == -1).all() and p.pt2pt.local_idx.dtype == torch.int32
    assert int(p.size()) == 0
    w = torch.tensor([1.0, 0.0, 2.0, 0.0, 1.0])
    p2 = tpairings.Pairings(
        pt2pt=tpairings.PairsPt2Pt(p.pt2pt.local, p.pt2pt.globl, w,
                                   p.pt2pt.local_idx, p.pt2pt.global_idx),
        pt2ln=p.pt2ln, pt2pl=p.pt2pl, ln2ln=p.ln2ln, pl2pl=p.pl2pl,
        potential_pairings=p.potential_pairings,
    )
    assert int(p2.size()) == 3


def _constructed(**kw):
    """Every tensor made by the constructors that take ``device=``."""
    xyz = np.random.RandomState(0).uniform(-1, 1, (10, 3)).astype(np.float32)
    pc = PointCloud.from_numpy(xyz, intensity=np.ones(10), ring=np.ones(10),
                               time=np.ones(10), **kw)
    pc2 = convert.pointcloud_from_numpy(np.zeros((16, 3)), 10, intensity=np.ones(16), **kw)
    pose = convert.pose_from_numpy(np.eye(3), np.zeros(3), **kw)
    eye = se3.identity(**kw)
    ypr = se3.from_xyz_ypr(1.0, 2.0, 3.0, 0.1, 0.2, 0.3, **kw)
    pairs = tpairings.Pairings.empty(pt2pt_cap=4, **kw)
    block = tpairings.PairsPt2Pl.empty(3, **kw)
    none = tpairings.concat_blocks([], tpairings.PairsPt2Pt, **kw)
    out = [pc.xyz, pc.count, pc.intensity, pc.ring, pc.time, pc2.xyz, pc2.count,
           pc2.intensity, pose.R, pose.t, eye.R, eye.t, ypr.R, ypr.t,
           pairs.potential_pairings]
    for b in (pairs.pt2pt, pairs.pt2ln, pairs.pt2pl, pairs.ln2ln, pairs.pl2pl, block, none):
        out += [getattr(b, f.name) for f in dataclasses.fields(b)]
    return out


def test_constructors_follow_the_requested_cpu():
    """This file asks for the CPU once (the fixture above): every
    constructor then yields CPU tensors, with and without ``device=``."""
    assert mp2p_icp_tpu_torch.default_device() == torch.device("cpu")
    for t in _constructed() + _constructed(device="cpu"):
        assert t.device.type == "cpu"


def test_default_device_is_the_card_without_a_request():
    """In a fresh process, without a request, the default is ``cuda``:
    read without touching a card. A request changes it, and withdrawing
    the request restores it; nothing looks whether a card is there."""
    code = (
        "import torch, mp2p_icp_tpu_torch as m; "
        "assert m.default_device() == torch.device('cuda'), m.default_device(); "
        "m.set_default_device('cpu'); assert m.default_device().type == 'cpu'; "
        "m.set_default_device('cuda:1'); assert m.default_device() == torch.device('cuda', 1); "
        "m.set_default_device(None); assert m.default_device() == torch.device('cuda'); "
        "assert not torch.cuda.is_initialized()"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr


def test_no_request_and_no_card_raises_torchs_own_error():
    """Without a card and without a request the constructors do not give
    way to the CPU: torch's error surfaces. (Where a card is present the
    same call succeeds on it.)"""
    code = (
        "import sys, torch, numpy as np\n"
        "from mp2p_icp_tpu_torch.core.pointcloud import PointCloud\n"
        "try:\n"
        "    pc = PointCloud.from_numpy(np.zeros((4, 3)))\n"
        "except (AssertionError, RuntimeError) as e:\n"
        "    sys.exit(0 if not torch.cuda.is_available() else 1)\n"
        "sys.exit(0 if pc.xyz.device.type == 'cuda' else 1)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.cuda
def test_constructors_default_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: checks where the constructors put tensors")
    mp2p_icp_tpu_torch.set_default_device(None)
    try:
        for t in _constructed():
            assert t.device.type == "cuda"
        for t in _constructed(device="cpu"):
            assert t.device.type == "cpu"
    finally:
        mp2p_icp_tpu_torch.set_default_device("cpu")


def test_package_does_not_import_jax():
    """Every module of the package, found by walking it (so that io/ and
    apps/ are covered), imports in a fresh process without jax, the JAX
    package or matplotlib (the viewers import it only to draw a PNG)."""
    code = (
        "import importlib, pkgutil, sys, mp2p_icp_tpu_torch as pkg; "
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]; "
        "[importlib.import_module(n) for n in names]; "
        "assert {'mp2p_icp_tpu_torch.io.mrpt_mm', 'mp2p_icp_tpu_torch.apps.kitti_odometry', "
        "'mp2p_icp_tpu_torch.apps.sm_cli', 'mp2p_icp_tpu_torch.io.native', "
        "'mp2p_icp_tpu_torch.apps.mm_viewer', 'mp2p_icp_tpu_torch.apps.icp_log_viewer', "
        "'mp2p_icp_tpu_torch.utils.profiler', 'mp2p_icp_tpu_torch.ops.voxel_hash'} "
        "<= set(names), names; "
        "assert 'jax' not in sys.modules, 'jax was imported'; "
        "assert 'mp2p_icp_tpu' not in sys.modules, 'the JAX package was imported'; "
        "assert 'matplotlib' not in sys.modules, 'matplotlib was imported'"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_nothing_of_the_jax_side():
    """chip_smoke.py imports torch, numpy and the port:
    neither jax, nor the JAX package, nor the JAX benchmark's script."""
    code = (
        "import sys, chip_smoke; "
        "bad = [m for m in ('jax', 'mp2p_icp_tpu', 'bench') if m in sys.modules]; "
        "assert not bad, bad; "
        "assert callable(chip_smoke.main) and 'mp2p_icp_tpu_torch' in sys.modules"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr


# Public names of the JAX package that the port leaves out by design
# (ROADMAP, "Code of the JAX package that the port does not need"), each
# with its reason.
OMITTED = {
    ("matchers.base", "GridCache"): "the matchers' grids argument: every production call "
                                    "passes {} and no matcher reads it",
    ("ops.nn_bruteforce", "BATCH_VMEM_BUDGET"): "a compiler workaround: the TPU's VMEM "
                                                "slabbing of the batched kernel",
}


def _jax_modules():
    """(dotted name under the package, path) of every module of mp2p_icp_tpu."""
    root = Path(__file__).resolve().parents[1] / "mp2p_icp_tpu"
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts), path


def _public_names(path):
    """{name: [public method names] or None} of a module's top-level
    functions, classes and assigned constants (read with ast: the JAX
    package is not imported)."""
    import ast

    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ClassDef):
            out[node.name] = [f.name for f in node.body if isinstance(f, ast.FunctionDef)
                              and not f.name.startswith("_")]
        elif isinstance(node, ast.FunctionDef):
            out[node.name] = None
        elif isinstance(node, ast.Assign):
            out.update({t.id: None for t in node.targets if isinstance(t, ast.Name)})
    return {k: v for k, v in out.items() if not k.startswith("_")}


def test_every_module_and_public_name_of_the_jax_package_is_ported():
    """Each module of mp2p_icp_tpu has its counterpart in the port, and each
    public top-level function, class (with its public methods) and constant
    exists there, but for OMITTED."""
    import importlib

    missing = []
    for rel, path in _jax_modules():
        name = "mp2p_icp_tpu_torch" + (f".{rel}" if rel else "")
        try:
            mod = importlib.import_module(name)
        except ModuleNotFoundError:
            missing.append(name)
            continue
        for attr, methods in _public_names(path).items():
            if (rel, attr) in OMITTED:
                assert not hasattr(mod, attr), f"{name}.{attr} is ported: drop it from OMITTED"
                continue
            if not hasattr(mod, attr):
                missing.append(f"{name}.{attr}")
                continue
            missing += [f"{name}.{attr}.{m}" for m in methods or ()
                        if not hasattr(getattr(mod, attr), m)]
    assert not missing, missing


def test_random_pose_is_a_uniform_rigid_motion():
    """se3.random_pose draws from an explicit generator: the same seed gives
    the same pose, rotations are proper, the angle and translation stay in
    their ranges and the axes spread over the sphere."""
    g = torch.Generator().manual_seed(3)
    poses = [se3.random_pose(g, max_trans=2.0, max_angle=1.5) for _ in range(200)]
    again = se3.random_pose(torch.Generator().manual_seed(3), max_trans=2.0, max_angle=1.5)
    assert torch.equal(again.R, poses[0].R) and torch.equal(again.t, poses[0].t)
    R = torch.stack([p.R for p in poses])
    t = torch.stack([p.t for p in poses])
    eye = torch.eye(3).expand(200, 3, 3)
    _close(R @ R.transpose(-1, -2), eye)
    _close(torch.linalg.det(R), np.ones(200))
    angles = torch.linalg.vector_norm(se3.so3_log(R), dim=-1)
    assert float(angles.max()) <= 1.5 + 1e-5 and float(angles.min()) >= 0.0
    assert float(t.abs().max()) <= 2.0 and float(t.abs().max()) > 1.5
    axes = se3.so3_log(R) / angles[:, None]
    assert float(axes.mean(0).abs().max()) < 0.2  # no preferred direction
    assert poses[0].t.device.type == "cpu"


def test_pose_matrix_and_batch_shape_match_jax():
    rng = np.random.RandomState(5)
    tang = rng.uniform(-1, 1, (4, 6)).astype(np.float32)
    pj = jse3.exp(jnp.asarray(tang))  # the same R and t in both packages
    pt = se3.Pose(torch.from_numpy(np.array(pj.R)), torch.from_numpy(np.array(pj.t)))
    assert tuple(pt.batch_shape) == tuple(pj.batch_shape) == (4,)
    np.testing.assert_array_equal(pt.as_matrix().numpy(), np.asarray(pj.as_matrix()))
    one = se3.Pose(pt.R[0], pt.t[0])
    assert tuple(one.batch_shape) == () and one.as_matrix().shape == (4, 4)
    np.testing.assert_array_equal(one.as_matrix().numpy(),
                                  np.asarray(jse3.Pose(pj.R[0], pj.t[0]).as_matrix()))


def test_pointcloud_helpers_match_jax():
    """bounding_box, with_points, empty and sanity_check against the JAX
    package's, on a padded cloud, an empty one and a bad channel."""
    from mp2p_icp_tpu.core.pointcloud import sanity_check as jsanity
    from mp2p_icp_tpu_torch.core.pointcloud import sanity_check

    rng = np.random.RandomState(6)
    xyz = rng.uniform(-9, 9, (300, 3)).astype(np.float32)
    pt, pj = PointCloud.from_numpy(xyz, capacity=512), JPointCloud.from_numpy(xyz, capacity=512)
    for a, b in zip(pt.bounding_box(), pj.bounding_box()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    et, ej = PointCloud.empty(64), JPointCloud.empty(64)
    np.testing.assert_array_equal(et.xyz.numpy(), np.asarray(ej.xyz))
    assert int(et.count) == int(ej.count) == 0 and et.count.dtype == torch.int32
    for a, b in zip(et.bounding_box(), ej.bounding_box()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))  # (+inf, -inf)
    moved = pt.with_points(pt.xyz + 1.0, torch.tensor(10, dtype=torch.int32))
    assert int(moved.count) == 10 and moved.capacity == 512
    np.testing.assert_array_equal(moved.bounding_box()[1].numpy(), xyz[:10].max(0) + 1.0)
    assert sanity_check(pt) == jsanity(pj) is True
    bad_t = dataclasses.replace(pt, intensity=torch.zeros(100))
    bad_j = dataclasses.replace(pj, intensity=jnp.zeros(100))
    assert sanity_check(bad_t) == jsanity(bad_j) is False


def test_out_capacity_and_empty_flag_match_jax():
    """The matchers' out_capacity (Adaptive: and out_capacity_pt2pl) for a
    two-layer local map, and Pairings.empty_flag, as the JAX package's."""
    from mp2p_icp_tpu.core.pairings import Pairings as JPairings
    from mp2p_icp_tpu import matchers as jm
    from mp2p_icp_tpu_torch import matchers as tm

    layers_t = {"raw": PointCloud.empty(1024), "dec": PointCloud.empty(256)}
    layers_j = {"raw": JPointCloud.empty(1024), "dec": JPointCloud.empty(256)}
    lms = ("raw", "dec")
    for name, kw in (("MatcherPointsDistanceThreshold", {"pairings_per_point": 3}),
                     ("MatcherAdaptive", {"max_pt2pt_correspondences": 2}),
                     ("MatcherPoint2Plane", {}), ("MatcherPoint2Line", {}),
                     ("MatcherPointsInlierRatio", {})):
        mt = getattr(tm, name)(layer_matches=tuple(tm.LayerMatch(x, x) for x in lms), **kw)
        mj = getattr(jm, name)(layer_matches=tuple(jm.LayerMatch(x, x) for x in lms), **kw)
        assert mt.out_capacity(layers_t) == mj.out_capacity(layers_j), name
        if name == "MatcherAdaptive":
            assert mt.out_capacity_pt2pl(layers_t) == mj.out_capacity_pt2pl(layers_j) == 1280
    pt = tpairings.Pairings.empty(pt2pt_cap=8)
    assert bool(pt.empty_flag()) == bool(JPairings.empty(pt2pt_cap=8).empty_flag()) is True
    filled = dataclasses.replace(pt, pt2pt=dataclasses.replace(
        pt.pt2pt, weight=torch.ones(8)))
    assert not bool(filled.empty_flag())
