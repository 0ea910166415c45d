"""The port's Lie maps (``geometry.lie``, ``geometry.lie_np``) and Umeyama
alignment against the JAX package's, on the same seeded inputs, and their
forward-mode Jacobians against ``jax.jacfwd``.

Tolerances. float32 maps: 2e-6 absolute away from π, where both packages
round the same closed forms; inside so3_log's π-window (θ > π − 0.014) the
axis is recovered from the symmetric part, whose f32 error grows as
1/(π − θ): the float64 answer is ~1e-4 from either package there, so the
port is held to 4e-4 of the reference. Jacobians: twice the reference's
distance from a float64 evaluation, plus 2e-6 (1e-5 for the SE3
residual). ``lie_np`` runs in float64: 1e-12 (1e-9 through a log).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_parity import t, to_np

from mvslam_tpu.backend.factor_graph import SE3Model as JSE3Model
from mvslam_tpu.geometry import alignment as jal
from mvslam_tpu.geometry import lie as jl
from mvslam_tpu.geometry import lie_np as jlnp
from mvslam_tpu_torch.backend.factor_graph import SE3Model
from mvslam_tpu_torch.geometry import alignment as tal
from mvslam_tpu_torch.geometry import lie as tl
from mvslam_tpu_torch.geometry import lie_np as tlnp


def _axes(seed, n):
    rng = np.random.default_rng(seed)
    fixed = np.asarray([[1, -1, 0], [1, 1, -1], [-1, 1, 1], [0.19, -0.2, 0.96]], float)
    a = np.concatenate([fixed, rng.normal(size=(n, 3))])
    return a / np.linalg.norm(a, axis=1, keepdims=True)


# (name, angles, tolerance): the identity, tiny angles, generic angles, and
# the π-window on mixed-sign axes.
# Four angles each, so every regime has one shape (JAX's eager op cache).
REGIMES = {
    "identity": ([0.0] * 4, 2e-6),
    "tiny": ([1e-9, 3e-6, 3e-4, 3e-3], 2e-6),
    "generic": ([0.3, 1.0, 2.0, 2.5], 2e-6),
    "near_pi": ([np.pi - 0.015, np.pi - 5e-3, np.pi - 1e-4, np.pi], 4e-4),
}


def _rvecs(regime, seed=0):
    angles, tol = REGIMES[regime]
    a = _axes(seed, 6)
    return np.concatenate([a * th for th in angles]).astype(np.float32), tol


@pytest.mark.parametrize("regime", list(REGIMES))
def test_so3_exp_and_log_equal_reference(regime):
    rv, tol = _rvecs(regime)
    R_ref = np.asarray(jl.so3_exp(jnp.asarray(rv)))
    R = to_np(tl.so3_exp(t(rv)))
    np.testing.assert_allclose(R, R_ref, atol=2e-6)
    # The log of the SAME matrices: only the log's rounding differs.
    np.testing.assert_allclose(to_np(tl.so3_log(t(R_ref))), np.asarray(jl.so3_log(jnp.asarray(R_ref))), atol=tol)
    # The rotation the port's log returns is the input rotation.
    np.testing.assert_allclose(to_np(tl.so3_exp(tl.so3_log(t(R_ref)))), R_ref, atol=5e-4)
    np.testing.assert_allclose(
        to_np(tl.rotation_angle_deg(t(R_ref))), np.asarray(jl.rotation_angle_deg(jnp.asarray(R_ref))), atol=0.05
    )


@pytest.mark.parametrize("regime", list(REGIMES))
def test_se3_sim3_and_left_jacobians_equal_reference(regime):
    rv, tol = _rvecs(regime, seed=1)
    rng = np.random.default_rng(2)
    xi = np.concatenate([rng.normal(size=rv.shape).astype(np.float32), rv], axis=1)
    T_ref = np.asarray(jl.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(to_np(tl.se3_exp(t(xi))), T_ref, atol=1e-5)
    np.testing.assert_allclose(to_np(tl.se3_log(t(T_ref))), np.asarray(jl.se3_log(jnp.asarray(T_ref))), atol=10 * tol)
    np.testing.assert_allclose(to_np(tl.se3_inverse(t(T_ref))), np.asarray(jl.se3_inverse(jnp.asarray(T_ref))), atol=1e-6)
    np.testing.assert_allclose(
        to_np(tl.se3_relative(t(T_ref), t(T_ref[::-1].copy()))),
        np.asarray(jl.se3_relative(jnp.asarray(T_ref), jnp.asarray(T_ref[::-1]))), atol=1e-5,
    )
    for name in ("_left_jacobian", "_left_jacobian_inv"):
        np.testing.assert_allclose(to_np(getattr(tl, name)(t(rv))), np.asarray(getattr(jl, name)(jnp.asarray(rv))), atol=1e-5)
    p = np.concatenate([xi, rng.uniform(-0.5, 0.5, size=(len(xi), 1)).astype(np.float32)], axis=1)
    S_ref = np.asarray(jl.sim3_matrix(jnp.asarray(p)))
    np.testing.assert_allclose(to_np(tl.sim3_matrix(t(p))), S_ref, atol=1e-5)
    np.testing.assert_allclose(to_np(tl.sim3_params(t(S_ref))), np.asarray(jl.sim3_params(jnp.asarray(S_ref))), atol=10 * tol)
    np.testing.assert_allclose(to_np(tl.sim3_inverse(t(S_ref))), np.asarray(jl.sim3_inverse(jnp.asarray(S_ref))), rtol=1e-5, atol=1e-5)


def test_se2_and_wrap_angle_equal_reference():
    rng = np.random.default_rng(3)
    p = np.concatenate([rng.normal(size=(16, 2)), rng.uniform(-7, 7, size=(16, 1))], axis=1).astype(np.float32)
    T_ref = np.asarray(jl.se2_matrix(jnp.asarray(p)))
    np.testing.assert_allclose(to_np(tl.se2_matrix(t(p))), T_ref, atol=1e-6)
    np.testing.assert_allclose(to_np(tl.se2_params(t(T_ref))), np.asarray(jl.se2_params(jnp.asarray(T_ref))), atol=1e-6)
    th = np.asarray([-np.pi, np.pi, 3 * np.pi, -7.0, 0.0, 1e-8], np.float32)
    np.testing.assert_allclose(to_np(tl.wrap_angle(t(th))), np.asarray(jl.wrap_angle(jnp.asarray(th))), atol=1e-6)
    np.testing.assert_array_equal(to_np(tl.hat(t(p))), np.asarray(jl.hat(jnp.asarray(p))))


@pytest.mark.parametrize("regime", list(REGIMES))
def test_lie_np_equals_reference_in_float64(regime):
    rv, _ = _rvecs(regime, seed=4)
    rv = rv.astype(np.float64)
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(size=rv.shape), rv], axis=1)
    R = jlnp.so3_exp(rv)
    np.testing.assert_allclose(tlnp.so3_exp(rv), R, atol=1e-12)
    np.testing.assert_allclose(tlnp.so3_log(R), jlnp.so3_log(R), atol=1e-9)
    T = jlnp.se3_params_to_matrix(x)
    np.testing.assert_allclose(tlnp.se3_params_to_matrix(x), T, atol=1e-12)
    np.testing.assert_allclose(tlnp.se3_matrix_to_params(T), jlnp.se3_matrix_to_params(T), atol=1e-9)
    np.testing.assert_allclose(tlnp.se3_inverse(T), jlnp.se3_inverse(T), atol=1e-12)
    s = np.concatenate([x, rng.uniform(-0.5, 0.5, size=(len(x), 1))], axis=1)
    S = jlnp.sim3_matrix(s)
    np.testing.assert_allclose(tlnp.sim3_matrix(s), S, atol=1e-12)
    np.testing.assert_allclose(tlnp.sim3_params(S), jlnp.sim3_params(S), atol=1e-9)
    np.testing.assert_allclose(tlnp.sim3_inverse(S), jlnp.sim3_inverse(S), atol=1e-12)
    q = x[:, :3]
    np.testing.assert_allclose(tlnp.se2_params(tlnp.se2_matrix(q)), jlnp.se2_params(jlnp.se2_matrix(q)), atol=1e-12)
    assert isinstance(tlnp.so3_exp(rv), np.ndarray) and tlnp.so3_exp(rv).dtype == np.float64


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama_alignment_equals_reference(with_scale):
    rng = np.random.default_rng(6)
    src = rng.normal(size=(40, 3)).astype(np.float32)
    R_true = np.asarray(jl.so3_exp(jnp.asarray([0.3, -0.5, 0.9], jnp.float32)))
    dst = (1.7 * src @ R_true.T + [0.5, -1.0, 2.0] + rng.normal(scale=0.01, size=src.shape)).astype(np.float32)
    R_j, t_j, s_j = jal.umeyama_alignment(jnp.asarray(src), jnp.asarray(dst), with_scale=with_scale)
    R_t, t_t, s_t = tal.umeyama_alignment(t(src), t(dst), with_scale=with_scale)
    np.testing.assert_allclose(to_np(R_t), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(to_np(t_t), np.asarray(t_j), atol=1e-4)
    assert float(s_t) == pytest.approx(float(s_j), rel=1e-5)
    np.testing.assert_allclose(
        to_np(tal.apply_similarity(t(src), R_t, t_t, s_t)),
        np.asarray(jal.apply_similarity(jnp.asarray(src), R_j, t_j, s_j)), atol=1e-4,
    )


def _jac_port(fn, x):
    return to_np(torch.func.vmap(torch.func.jacfwd(fn))(t(x)))


def _jac_ref(fn, x):
    return np.asarray(jax.jit(jax.vmap(jax.jacfwd(fn)))(jnp.asarray(x)))


def _f64_tolerance(J_ref, J_64, floor=2e-6):
    """The port may be as far from the reference as twice the reference is
    from the float64 evaluation of the same map (plus a floor): f32
    roundoff of the closed forms, not the port, sets the distance."""
    return floor + 2.0 * np.abs(J_ref - J_64).max()


@pytest.mark.parametrize("regime", ["identity", "tiny", "near_pi"])
def test_jacfwd_of_so3_maps_at_identity_and_near_pi(regime):
    """The safe-``where`` forms keep forward-mode tangents finite at rvec = 0
    and in the π-window, and equal to JAX's within the f32-vs-float64
    distance of the reference."""
    rv, _ = _rvecs(regime, seed=7)
    J = _jac_port(tl.so3_exp, rv)
    J_ref = _jac_ref(jl.so3_exp, rv)
    assert np.isfinite(J).all()
    np.testing.assert_allclose(J, J_ref, atol=_f64_tolerance(J_ref, _jac_port(tl.so3_exp, rv.astype(np.float64))))
    R = np.asarray(jl.so3_exp(jnp.asarray(rv)))
    J = _jac_port(tl.so3_log, R)
    J_ref = _jac_ref(jl.so3_log, R)
    assert np.isfinite(J).all()
    np.testing.assert_allclose(J, J_ref, atol=_f64_tolerance(J_ref, _jac_port(tl.so3_log, R.astype(np.float64))))
    if regime == "identity":
        np.testing.assert_array_equal(J, J_ref)


@pytest.mark.parametrize("regime", ["identity", "generic", "near_pi"])
def test_jacfwd_of_se3_residual(regime):
    """The SE3 between-factor's Jacobians in xi and xj, as the linearizer
    takes them: the window's first keyframe sits at the identity."""
    rv, _ = _rvecs(regime, seed=8)
    rng = np.random.default_rng(9)
    n = len(rv)
    xi = np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 3)) if regime == "identity" else rv], 1).astype(np.float32)
    xj = np.concatenate([rng.normal(size=(n, 3)), rv], 1).astype(np.float32)
    meas = np.concatenate([rng.normal(size=(n, 3)), rng.normal(scale=0.1, size=(n, 3))], 1).astype(np.float32)
    tm, jm = SE3Model(), JSE3Model()
    for arg in (0, 1):
        def port(*xs):
            return to_np(torch.func.vmap(torch.func.jacfwd(tm.residual, argnums=arg))(*(t(x) for x in xs)))

        J = port(xi, xj, meas)
        J_ref = np.asarray(
            jax.jit(jax.vmap(jax.jacfwd(jm.residual, argnums=arg)))(jnp.asarray(xi), jnp.asarray(xj), jnp.asarray(meas))
        )
        J_64 = port(*(x.astype(np.float64) for x in (xi, xj, meas)))
        assert np.isfinite(J).all()
        np.testing.assert_allclose(J, J_ref, atol=_f64_tolerance(J_ref, J_64, floor=1e-5))
