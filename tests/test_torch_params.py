"""Expressions over ICP_ITERATION in the port, against the JAX package on
the CPU: the evaluator itself (a table of expressions, each equal to the
JAX package's value at the same iteration as float32, which the JAX
package computes on its traced float32 iteration), the crop radius of the
two matchers that take expressions, and an align of each with
Expression fields (same termination, iterations ±1, pose gap < 5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from mp2p_icp_tpu.core import params as jparams
from mp2p_icp_tpu.core import se3 as jse3
from mp2p_icp_tpu.core.pointcloud import PointCloud as JPointCloud
from mp2p_icp_tpu.icp import ICP as JICP
from mp2p_icp_tpu.icp import ICPParameters as JICPParameters
from mp2p_icp_tpu.matchers import MatcherAdaptive as JAdaptive
from mp2p_icp_tpu.matchers import MatcherPointsDistanceThreshold as JDistance
from mp2p_icp_tpu.solvers.gauss_newton import GNParams as JGNParams
from mp2p_icp_tpu.solvers.robust import RobustKernel as JRobustKernel
from mp2p_icp_tpu.solvers.solver import SolverGaussNewton as JGN
from mp2p_icp_tpu.solvers.solver import SolverHorn as JHorn
import mp2p_icp_tpu_torch
from mp2p_icp_tpu_torch import convert
from mp2p_icp_tpu_torch.core import se3
from mp2p_icp_tpu_torch.core.params import Expression, ParameterSource, resolve_value
from mp2p_icp_tpu_torch.core.pointcloud import PointCloud
from mp2p_icp_tpu_torch.icp import ICPParameters
from mp2p_icp_tpu_torch.matchers.base import static_value


@pytest.fixture(autouse=True, scope="module")
def _ask_for_the_cpu():
    """The port's constructors default to the card; these tests run on the
    CPU and say so once for the whole file."""
    mp2p_icp_tpu_torch.set_default_device("cpu")
    yield
    mp2p_icp_tpu_torch.set_default_device(None)


# arithmetic, calls on constants, comparisons, conditionals, the $f{} form:
# forms the JAX package can evaluate on a traced iteration, equal to the bit
TABLE = [
    "2.0 - 0.1*ICP_ITERATION",
    "$f{0.9 - 0.05*ICP_ITERATION}",
    "1.0 / (1.0 + 0.5*ICP_ITERATION)",
    "sqrt(2.0) * ICP_ITERATION + pi",
    "0.1*0.3*ICP_ITERATION + 1",
    "(2.0 - 0.1*ICP_ITERATION) * 0.5",
    "ICP_ITERATION % 3 + ICP_ITERATION // 4",
    "ICP_ITERATION > 3",
    "ICP_ITERATION <= 3",
    "2.0 - 0.05*ICP_ITERATION if ICP_ITERATION < 30 else 0.5",
    "0.25 if ICP_ITERATION == 2 else (1.5 if ICP_ITERATION != 5 else 2.5)",
    "deg2rad(30.0) + 0.0*ICP_ITERATION",
    "7",
]


# forms that XLA rewrites (a division by a constant becomes a product with
# its reciprocal; a chain of products is reassociated): 1 ulp apart at most
REWRITTEN = ["-ICP_ITERATION ** 2 / 7.0 + 3", "ICP_ITERATION*0.1*0.3"]


def _traced(text):
    """The JAX package's value on its traced float32 iteration."""
    ej = jparams.Expression(text)
    f = jax.jit(lambda it: jnp.asarray(ej({"ICP_ITERATION": it.astype(jnp.float32)}),
                                       jnp.float32))
    return lambda it: np.float32(f(jnp.asarray(it, jnp.int32)))


@pytest.mark.parametrize("text", TABLE + REWRITTEN)
def test_expression_matches_jax(text):
    ej, et = jparams.Expression(text), Expression(text)
    assert et.variables == ej.variables and et.text == ej.text
    traced = _traced(text)
    for it in range(0, 200, 3):
        want = traced(it)
        got = static_value(et, "x", it)
        assert isinstance(got, float)
        ulps = 1 if text in REWRITTEN else 0
        assert abs(np.float32(got) - want) <= ulps * abs(np.spacing(want)), (text, it, got, want)
        # a tensor iteration gives the same value as a float32 tensor
        t = static_value(et, "x", torch.tensor(it, dtype=torch.int32))
        assert t.dtype == torch.float32 and float(t) == got


def test_multiply_add_is_rounded_once():
    """2.0 - 0.1*i in float32 arithmetic (two roundings) differs from the
    JAX package's value at some iterations, where XLA fuses the multiply-add
    and rounds once: the port gives the JAX package's value there too."""
    e, traced = Expression("2.0 - 0.1*ICP_ITERATION"), _traced("2.0 - 0.1*ICP_ITERATION")
    two_roundings = [np.float32(2.0) - np.float32(0.1) * np.float32(i) for i in range(64)]
    differ = [i for i in range(64) if two_roundings[i] != traced(i)]
    assert differ
    assert all(np.float32(static_value(e, "x", i)) == traced(i) for i in differ)


def test_max_form_on_the_host_equals_the_conditional_form():
    """max(...) needs a host value: the port evaluates it at each iteration
    (the JAX package cannot trace it); it equals the conditional form that
    both packages evaluate."""
    a = Expression("max(0.5, 2.0 - 0.05*ICP_ITERATION)")
    b = Expression("2.0 - 0.05*ICP_ITERATION if ICP_ITERATION < 30 else 0.5")
    assert [static_value(a, "x", i) for i in range(100)] == \
        [static_value(b, "x", i) for i in range(100)]
    with pytest.raises(TypeError):
        static_value("2.0", "x", 0)
    assert static_value(3, "x", 9) == 3.0


def test_vmap_evaluates_per_problem():
    e = Expression("1.5 if ICP_ITERATION < 4 else 0.5 + 0.01*ICP_ITERATION")
    its = torch.tensor([0, 3, 4, 9], dtype=torch.int32)
    out = torch.func.vmap(lambda i: static_value(e, "x", i))(its)
    assert out.tolist() == [static_value(e, "x", int(i)) for i in its]


def test_resolve_value_and_parameter_source():
    for v in (3, 2.5, True, "1 + 2*3", "$f{pi/2}"):
        assert resolve_value(v) == jparams.resolve_value(v)
    assert resolve_value("x * 2", {"x": 4.0}) == 8.0
    with pytest.raises(TypeError):
        resolve_value(None)
    with pytest.raises(KeyError):
        Expression("y + 1")({})
    with pytest.raises(ValueError, match="not allowed"):
        Expression("open(1)")({})
    src = ParameterSource()
    src.update_variables({"vx": 2, "robot_x": -1.5})
    assert src.variables == {"vx": 2.0, "robot_x": -1.5}
    assert src.realize(Expression("vx * robot_x")) == -3.0
    assert hash(Expression("1+1")) == hash(Expression("1+1")) and \
        Expression("1+1") == Expression("$f{1+1}")


def test_search_radius_matches_jax():
    """The crop margin of an Expression field: DistanceThreshold at
    iteration 0, Adaptive the largest value over iterations 0..512."""
    for jm in (JDistance(threshold=jparams.Expression("2.0 - 0.1*ICP_ITERATION")),
               JDistance(threshold=jparams.Expression("1.0 + 0*ICP_ITERATION"),
                         threshold_angular_deg=0.5),
               JAdaptive(absolute_max_search_distance=jparams.Expression(
                   "1.0 + 0.002*ICP_ITERATION")),
               JAdaptive(absolute_max_search_distance=jparams.Expression(
                   "2.0 - 0.05*ICP_ITERATION if ICP_ITERATION < 30 else 0.5"))):
        tm = convert.matcher_from_config(*convert.config_of(jm))
        assert tm.search_radius() == pytest.approx(jm.search_radius(), rel=1e-6)


GT = (1.1, 0.05, 0.01, 0.01, 0.002, 0.001)


@pytest.fixture(scope="module")
def street_pair():
    """bench.py's street pair at 2048 points: numpy (global, local)."""
    scene = bench.make_scene(np.random.RandomState(0))
    g = bench.sample_scan(scene, np.random.RandomState(1), n=2048)
    loc = bench.sample_scan(scene, np.random.RandomState(2), n=2048)
    gt = se3.from_xyz_ypr(*GT)
    return g, se3.apply(se3.inverse(gt), torch.from_numpy(loc)).numpy()


@pytest.mark.parametrize("which", ["distance_threshold", "adaptive"])
def test_align_with_expression_fields_matches_jax(street_pair, which):
    """A DistanceThreshold align whose threshold shrinks with the iteration
    and whose GN kernel parameter is an expression; the KITTI schedule with
    Adaptive's confidence interval and search distance as expressions."""
    gn = JGN(run_from_iteration=6, gn_params=JGNParams(
        max_iterations=3, kernel=JRobustKernel.GEMAN_MCCLURE,
        kernel_param=jparams.Expression("0.3 - 0.01*ICP_ITERATION")))
    if which == "distance_threshold":
        matchers = [JDistance(threshold=jparams.Expression(
            "2.0 - 0.1*ICP_ITERATION if ICP_ITERATION < 15 else 0.5"))]
        solvers = [JHorn(run_up_to_iteration=5), gn]
    else:
        matchers = [JDistance(threshold=2.0, run_up_to_iteration=5),
                    JAdaptive(confidence_interval=jparams.Expression(
                        "0.9 - 0.01*ICP_ITERATION"), first_to_second_distance_max=1.2,
                        absolute_max_search_distance=jparams.Expression(
                            "2.0 - 0.05*ICP_ITERATION if ICP_ITERATION < 30 else 0.5"),
                        run_from_iteration=6)]
        solvers = [JHorn(run_up_to_iteration=5), gn]
    g, loc = street_pair
    jres = JICP(matchers=matchers, solvers=solvers).align(
        {"raw": JPointCloud.from_numpy(loc)}, {"raw": JPointCloud.from_numpy(g)},
        jse3.identity(), JICPParameters(max_iterations=40))
    ticp = convert.icp_from_config([convert.config_of(m) for m in matchers],
                                   [convert.config_of(s) for s in solvers])
    assert isinstance(ticp.solvers[1].gn_params.kernel_param, Expression)
    res = ticp.align({"raw": PointCloud.from_numpy(loc)}, {"raw": PointCloud.from_numpy(g)},
                     se3.identity(), ICPParameters(max_iterations=40))
    assert int(res.termination_reason) == int(jres.termination_reason)
    assert abs(res.n_iterations - int(jres.n_iterations)) <= 1
    pj = convert.pose_from_numpy(np.asarray(jres.optimal_tf.R), np.asarray(jres.optimal_tf.t))
    assert float(se3.error_log_norm(pj, res.optimal_tf)) < 5e-3
    assert float(se3.error_log_norm(se3.from_xyz_ypr(*GT), res.optimal_tf)) < 0.1
