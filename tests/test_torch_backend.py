"""The port's factor graphs, Gauss-Newton solvers, pose graphs and
optimization supervisor against the JAX package's, on the same graphs.

Tolerances, from float64 runs of the same graphs: residuals 1e-5 and
Jacobians 1e-4 absolute (f32 closed forms); pose-graph solutions 1e-4, the
final cost within 1e-4 relative plus 1e-7 absolute. ``converged`` is equal
everywhere and the Cholesky iteration count too. CG's last iteration can
differ by one: it ends when a step no longer lowers the cost, and the last
steps change the cost by less than f32 rounding, so whether one more is
kept is a coin toss in either package. Digests are equal as strings: they
hash inputs, and on the exact graph below every computed float is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_parity import t, to_np

from mvslam_tpu.backend import factor_graph as jfg
from mvslam_tpu.backend import optimization_control as joc
from mvslam_tpu.backend import pose_graph as jpg
from mvslam_tpu.backend import solvers as js
from mvslam_tpu_torch.backend import factor_graph as tfg
from mvslam_tpu_torch.backend import optimization_control as toc
from mvslam_tpu_torch.backend import pose_graph as tpg
from mvslam_tpu_torch.backend import solvers as ts
from mvslam_tpu_torch.backend.segments import segment_sum, segment_table

from test_backend_solvers import square_trajectory_graph


def _mirror(ref_graph, cls):
    """The port's pose graph holding the reference graph's chain and loops."""
    g = cls(solver=ref_graph.solver_name, device="cpu")
    g._params = [p.copy() for p in ref_graph._params]
    g._odometry = list(ref_graph._odometry)
    g._loops = list(ref_graph._loops)
    return g


def se2_loop():
    g = square_trajectory_graph()
    g.add_loop(0, len(g) - 1, np.zeros(3), weight=10.0)
    return g


def se3_loop():
    rng = np.random.default_rng(1)
    g = jpg.PoseGraph3D()
    for _ in range(10):
        g.add_pose(np.asarray([1.0, 0, 0, 0, 0, 0.1]) + rng.normal(scale=0.02, size=6))
    g.add_loop(0, 10, np.asarray([10.0, 0, 0, 0, 0, 1.0]), weight=5.0)
    return g


def sim3_loop():
    g = jpg.PoseGraphSim3D()
    for _ in range(6):
        g.add_pose(np.asarray([1.0, 0, 0, 0, 0, 0, 0.05]))
    g.add_loop(0, 6, np.asarray([6.0, 0, 0, 0, 0, 0, 0.0]), weight=10.0)
    return g


GRAPHS = {
    "se2": (se2_loop, tpg.PoseGraph),
    "se3": (se3_loop, tpg.PoseGraph3D),
    "sim3": (sim3_loop, tpg.PoseGraphSim3D),
}


def _problems(model):
    make, cls = GRAPHS[model]
    ref = make()
    port = _mirror(ref, cls)
    return ref, port, ref._build_graph().build_problem(), port._build_graph().build_problem(device="cpu")


def test_segment_sum_is_a_segment_sum():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 7, size=50)
    vals = rng.normal(size=(50, 2, 3)).astype(np.float32)
    keep = rng.random(50) > 0.3
    expect = np.zeros((9, 2, 3), np.float32)
    np.add.at(expect, ids[keep], vals[keep])
    got = segment_sum(t(vals), segment_table(ids, 9, keep=keep))
    np.testing.assert_allclose(to_np(got), expect, atol=1e-5)
    assert to_np(segment_table([], 3)).shape == (3, 1)


@pytest.mark.parametrize("model", list(GRAPHS))
def test_residuals_and_jacobians_equal_reference(model):
    _, _, jp, tp = _problems(model)
    jm, tm = jfg.MODELS[model], tfg.MODELS[model]
    # Perturb the state so the residuals are not ~0.
    rng = np.random.default_rng(2)
    x = (np.asarray(jp.x0) + rng.normal(scale=0.05, size=jp.x0.shape)).astype(np.float32)
    args_j = (jnp.asarray(x), jp.edges, jp.measurements, jp.weights)
    args_t = (t(x), tp.edges, tp.measurements, tp.weights)
    res_j = np.asarray(jax.jit(jfg.make_residual_fn(jm))(*args_j))
    np.testing.assert_allclose(to_np(tfg.make_residual_fn(tm)(*args_t)), res_j, atol=1e-5)
    for a, b in zip(tfg.make_linearize_fn(tm)(*args_t), jax.jit(jfg.make_linearize_fn(jm))(*args_j)):
        np.testing.assert_allclose(to_np(a), np.asarray(b), atol=1e-4)
    x0 = torch.as_tensor(x)
    delta = torch.full_like(x0, 0.01)
    np.testing.assert_allclose(to_np(tm.retract(x0, delta)), np.asarray(jm.retract(jnp.asarray(x), jnp.asarray(to_np(delta)))), atol=1e-6)
    np.testing.assert_allclose(to_np(tm.compose(x0[1], x0[2])), np.asarray(jm.compose(jnp.asarray(x[1]), jnp.asarray(x[2]))), atol=1e-5)


@pytest.mark.parametrize("model", list(GRAPHS))
def test_graph_digests_and_problems_equal_reference(model):
    ref, port, jp, tp = _problems(model)
    assert port._build_graph().digest() == ref._build_graph().digest()
    assert port.snapshot().to_dict() == ref.snapshot().to_dict()
    assert toc.problem_digest(tp) == joc.stable_hash(
        {"model": jp.model_name, "n": jp.num_variables, "e": jp.num_factors, "x0": np.asarray(jp.x0),
         "edges": np.asarray(jp.edges), "meas": np.asarray(jp.measurements)}
    )
    np.testing.assert_array_equal(to_np(tp.x0), np.asarray(jp.x0))
    np.testing.assert_array_equal(to_np(tp.edges), np.asarray(jp.edges))
    np.testing.assert_array_equal(to_np(tp.anchor_mask), np.asarray(jp.anchor_mask))
    np.testing.assert_allclose(port.params, ref.params, atol=1e-12)
    np.testing.assert_allclose(port.poses(), np.asarray(ref.poses()), atol=1e-12)


@pytest.mark.parametrize("name", ["trivial", "huber", "cauchy", "tukey"])
def test_robust_loss_equals_reference(name):
    s = np.asarray([0.0, 0.25, 1.0, 3.9, 4.0, 100.0], np.float32)
    jl, tl = js.RobustLoss(name, scale=2.0), ts.RobustLoss(name, scale=2.0)
    np.testing.assert_allclose(to_np(tl.rho(t(s))), np.asarray(jl.rho(jnp.asarray(s))), rtol=1e-6)
    np.testing.assert_allclose(to_np(tl.weight(t(s))), np.asarray(jl.weight(jnp.asarray(s))), rtol=1e-6)


@pytest.mark.parametrize("method", ["cholesky", "cg"])
@pytest.mark.parametrize("model", list(GRAPHS))
def test_solve_problem_equals_reference(model, method):
    _, _, jp, tp = _problems(model)
    kw = dict(max_iterations=15, method=method, damping=1e-4, cg_iterations=100)
    rj = js.solve_problem(jp, js.SolverConfig(**kw))
    rt = ts.solve_problem(tp, ts.SolverConfig(**kw))
    np.testing.assert_allclose(rt.x, rj.x, atol=1e-4)
    assert rt.final_cost == pytest.approx(rj.final_cost, rel=1e-4, abs=1e-7)
    assert rt.initial_cost == pytest.approx(rj.initial_cost, rel=1e-5)
    assert rt.final_cost < rt.initial_cost
    assert rt.converged == rj.converged and rt.status == rj.status
    if method == "cholesky":
        assert rt.iterations == rj.iterations
    else:
        assert abs(rt.iterations - rj.iterations) <= 1
    # Anchors stay fixed; the histogram counts every factor.
    np.testing.assert_array_equal(rt.x[0], to_np(tp.x0[0]))
    assert sum(rt.residual_histogram.counts) == tp.num_factors
    assert len(rt.residual_histogram.edges) == len(rt.residual_histogram.counts) + 1
    assert rt.diagnostics[0].cost >= rt.diagnostics[-1].cost


@pytest.mark.parametrize("model", list(GRAPHS))
def test_pose_graph_optimize_equals_reference(model):
    ref, port, _, _ = _problems(model)
    cfg = dict(max_iterations=20, damping=1e-4)
    rj, rt = ref.optimize(js.SolverConfig(**cfg)), port.optimize(ts.SolverConfig(**cfg))
    assert rt.final_cost < rt.initial_cost and rt.converged == rj.converged
    np.testing.assert_allclose(port.params, ref.params, atol=1e-4)
    np.testing.assert_allclose(port.poses(), np.asarray(ref.poses()), atol=1e-4)


def test_conditioning_stats_equal_reference():
    _, _, jp, tp = _problems("se2")
    for damping in (0.0, 1e-6):
        cj, ct = js.conditioning_stats(jp, damping), ts.conditioning_stats(tp, damping)
        assert ct["condition_number"] == pytest.approx(cj["condition_number"], rel=1e-4)
        assert ct["min_diagonal"] == pytest.approx(cj["min_diagonal"], rel=1e-6)


def test_scipy_solver_equals_reference():
    """scipy differentiates the f32 residuals by finite differences at a
    step (~1.5e-8) below f32 resolution, so its path is set by rounding in
    either package: the port is held to the reference's answer within 2%
    of the cost and 0.02 in the parameters (a 6-pose loop keeps it short)."""
    rng = np.random.default_rng(4)
    ref = jpg.PoseGraph(solver="scipy")
    for _ in range(6):
        ref.add_pose(np.asarray([1.0, 0.0, np.pi / 3]) + rng.normal(scale=0.05, size=3))
    ref.add_loop(0, 6, np.zeros(3), weight=5.0)
    port = _mirror(ref, tpg.PoseGraph)
    rj, rt = ref.optimize(js.SolverConfig(max_iterations=5)), port.optimize(ts.SolverConfig(max_iterations=5))
    assert rt.final_cost < rt.initial_cost
    assert rt.initial_cost == pytest.approx(rj.initial_cost, rel=1e-5)
    assert rt.final_cost == pytest.approx(rj.final_cost, rel=2e-2)
    np.testing.assert_allclose(port.params, ref.params, atol=2e-2)
    np.testing.assert_array_equal(port.params[0], ref.params[0])
    assert ts.DEFAULT_REGISTRY.names() == js.DEFAULT_REGISTRY.names()
    with pytest.raises(KeyError):
        ts.DEFAULT_REGISTRY.get("nope")


def test_empty_problem():
    g = tfg.FactorGraph(model_name="se2")
    g.add_variable(0, np.zeros(3))
    result = ts.solve_problem(g.build_problem(device="cpu"), ts.SolverConfig())
    assert result.converged and result.iterations == 0


def _exact_graphs():
    """An SE2 chain with exactly consistent odometry at θ = 0: every
    residual, Jacobian and cost is exact in f32, in both packages."""
    out = []
    for pkg in (jpg, tpg):
        g = pkg.PoseGraph() if pkg is jpg else pkg.PoseGraph(device="cpu")
        for _ in range(6):
            g.add_pose(np.asarray([1.0, 0.0, 0.0]))
        g.add_loop(0, 6, np.asarray([6.0, 0.0, 0.0]), weight=2.0)
        out.append(g)
    return out


def _supervisor_runs(oc, problem, cfg_cls):
    """Two supervised runs of one problem: (supervisor, first report, second report)."""
    sup = oc.OptimizationSupervisor(clock=lambda: 0.0)
    sup.run(problem, "gauss_newton", cfg_cls(max_iterations=10, damping=1e-4))
    first = sup.last_report
    sup.run(problem, "gauss_newton", cfg_cls(max_iterations=10, damping=1e-4))
    return sup, first, sup.last_report


def test_supervisor_verdicts_and_event_digests_equal_reference():
    jg, tg = _exact_graphs()
    jp, tp = jg._build_graph().build_problem(), tg._build_graph().build_problem(device="cpu")
    sj, fj, lj = _supervisor_runs(joc, jp, js.SolverConfig)
    st, ft, lt = _supervisor_runs(toc, tp, ts.SolverConfig)
    assert (ft.regression.status, lt.regression.status) == (fj.regression.status, lj.regression.status) == (
        "no_baseline", "pass")
    assert lt.snapshot.digest == lj.snapshot.digest
    assert lt.to_dict() == lj.to_dict()
    assert joc.stable_hash(st.health_snapshot()) == joc.stable_hash(sj.health_snapshot())  # NaN-safe equality
    # The conditioning gate trips alike and returns x0.
    gate_j, gate_t = joc.OptimizationControlConfig(max_condition_number=1.0), toc.OptimizationControlConfig(
        max_condition_number=1.0)
    rj = joc.OptimizationSupervisor(gate_j, clock=lambda: 0.0)
    rt = toc.OptimizationSupervisor(gate_t, clock=lambda: 0.0)
    res_j, res_t = rj.run(jp, "gauss_newton", js.SolverConfig()), rt.run(tp, "gauss_newton", ts.SolverConfig())
    assert res_t.status == res_j.status == -2
    np.testing.assert_array_equal(res_t.x, to_np(tp.x0))
    assert rt.last_report.to_dict() == rj.last_report.to_dict()
    assert joc.stable_hash(rt.health_snapshot()) == joc.stable_hash(rj.health_snapshot())


def test_supervised_pose_graph_on_a_noisy_graph():
    """Noisy SE2 loop: the same verdicts, attempts and problem digest; the
    costs within the solver tolerance."""
    ref = se2_loop()
    port = _mirror(ref, tpg.PoseGraph)
    ref.supervisor = joc.OptimizationSupervisor(clock=lambda: 0.0)
    port.supervisor = toc.OptimizationSupervisor(clock=lambda: 0.0)
    rj = ref.optimize(js.SolverConfig(max_iterations=15, damping=1e-4))
    rt = port.optimize(ts.SolverConfig(max_iterations=15, damping=1e-4))
    a, b = port.supervisor.last_report, ref.supervisor.last_report
    assert (a.attempts, a.conditioning_tripped, a.regression.status) == (b.attempts, b.conditioning_tripped,
                                                                          b.regression.status)
    assert a.snapshot.digest == b.snapshot.digest
    assert [e["type"] for e in a.events] == [e["type"] for e in b.events]
    assert rt.final_cost == pytest.approx(rj.final_cost, rel=1e-4)
    regressed = toc.SolverRegressionGate(toc.OptimizationControlConfig())
    snap = a.snapshot
    regressed.check(snap)
    worse = toc.SolverSnapshot(**{**snap.to_dict(), "final_cost": snap.final_cost * 2, "iterations": snap.iterations + 11})
    verdict = regressed.check(worse)
    ref_gate = joc.SolverRegressionGate(joc.OptimizationControlConfig())
    ref_gate.check(joc.SolverSnapshot(**snap.to_dict()))
    assert verdict.status == "regressed" and verdict == toc.RegressionVerdict(
        **vars(ref_gate.check(joc.SolverSnapshot(**worse.to_dict()))))
