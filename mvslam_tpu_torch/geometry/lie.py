"""SO(3)/SE(3)/SE(2)/Sim(3) exponential and logarithm maps.

Port of ``mvslam_tpu/geometry/lie.py``. Every function is pure, batched over
leading axes, follows the input dtype and device, and is written for
``torch.func.jacfwd`` under ``torch.func.vmap``: branches are selected with
``torch.where`` (no data-dependent control flow, no in-place ops), and the
unselected branches stay finite — the Taylor coefficients take θ² and a
guarded square root, and ``so3_log`` regularises its norms with ``+1e-24`` —
so forward-mode tangents at the identity and near π are finite, as in the
reference. ``_clip`` is ``min(max(x, lo), hi)`` like ``jnp.clip``: torch's
``minimum``/``maximum`` split a tie's tangent in half as JAX's do, where
``torch.clamp`` passes it whole. Per-sample scalars (θ², cosθ, the
scale) keep a trailing axis of 1: forward-mode AD in PyTorch promotes the
tangent of a 0-dim tensor combined with a Python float (``x - 1.0``,
``x / 6.0``) to float64, which then clashes with the float32 matrices;
a 1-element axis keeps every tangent in the input's dtype.

Conventions: rotation vectors are axis·angle (rvec); SE(3) tangents are
``[rho(3), phi(3)]`` with ``T = [[exp(phi), V(phi) @ rho], [0, 1]]``; Sim(3)
adds a log-scale 7th component.
"""

from __future__ import annotations

import math

import torch

from mvslam_tpu_torch.geometry.linalg import det3x3, inv3x3

_EPS = 1e-8


def _full(like: torch.Tensor, value: float) -> torch.Tensor:
    return torch.full_like(like, value)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, _full(x, lo)), _full(x, hi))


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector (batched over leading dims)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _sinc_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sinθ/θ, (1-cosθ)/θ², (θ-sinθ)/θ³) as functions of θ²:
    polynomials in θ² below 1e-8, the closed forms on a guarded √θ² above."""
    small = theta2 < 1e-8
    safe = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (safe - torch.sin(safe)) / (safe**3))
    return A, B, C


def so3_exp(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: rotation vector → rotation matrix (batched)."""
    theta2 = (rvec * rvec).sum(dim=-1, keepdim=True)
    A, B, _ = _sinc_coeffs(theta2)
    K = hat(rvec)
    return _eye3(rvec, K.shape) + A[..., None] * K + B[..., None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix → rotation vector, stable near 0 and π.

    Generic branch: the axis from the antisymmetric part w (|w| = 2 sinθ),
    scaled by θ/(2 sinθ) (a series in 1 − cosθ near the identity). Inside
    the π-window (cosθ < −0.9999) the axis magnitudes come from the
    symmetric part, their relative signs from the row of
    M = R + Rᵀ − 2cosθ·I at the largest component, the global sign from w,
    and the angle from π − arcsin(|w|/2). See the reference for why each
    part is the better-conditioned one.
    """
    trace = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    cos_theta = _clip((trace - 1.0) * 0.5, -1.0, 1.0)  # (..., 1), as every per-sample scalar here
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    w_norm = torch.sqrt((w * w).sum(dim=-1, keepdim=True) + 1e-24)
    sin_theta = 0.5 * w_norm
    theta = torch.atan2(sin_theta, cos_theta)
    near_id = cos_theta > 1.0 - 1e-6
    near_pi = cos_theta < -0.9999
    one_minus_c = _clip(1.0 - cos_theta, 0.0, 2.0)
    scale_series = 0.5 + one_minus_c / 6.0 + one_minus_c * one_minus_c * 7.0 / 90.0
    scale_arccos = theta / torch.where(sin_theta.abs() < _EPS, _full(sin_theta, _EPS), 2.0 * sin_theta)
    scale_generic = torch.where(near_id, scale_series, scale_arccos)
    generic = w * scale_generic

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    denom = 1.0 - cos_theta
    aa = _clip((diag - cos_theta) / torch.where(denom.abs() < _EPS, _full(denom, _EPS), denom), 0.0, 1.0)
    axis_mag = torch.sqrt(aa + 1e-24)
    M = R + R.transpose(-1, -2) - 2.0 * cos_theta[..., None] * _eye3(R, R.shape)
    k = torch.argmax(axis_mag, dim=-1)  # first maximum, like jnp.argmax
    row_k = torch.gather(M, -2, k[..., None, None].expand(*k.shape, 1, 3))[..., 0, :]
    rel_sign = torch.where(row_k >= 0.0, torch.ones_like(row_k), -torch.ones_like(row_k))
    axis = rel_sign * axis_mag
    axis = axis / torch.sqrt((axis * axis).sum(dim=-1, keepdim=True) + 1e-24)
    dot = (w * axis).sum(dim=-1, keepdim=True)
    flip = torch.where(dot < 0.0, -torch.ones_like(dot), torch.ones_like(dot))
    theta_pi = math.pi - torch.asin(_clip(sin_theta, 0.0, 1.0 - 1e-7))
    pi_branch = flip * axis * theta_pi
    return torch.where(near_pi, pi_branch, generic)


def _left_jacobian(rvec: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V(φ) = I + B·K + C·K² (for SE(3) exp)."""
    theta2 = (rvec * rvec).sum(dim=-1, keepdim=True)
    _, B, C = _sinc_coeffs(theta2)
    K = hat(rvec)
    return _eye3(rvec, K.shape) + B[..., None] * K + C[..., None] * (K @ K)


def _left_jacobian_inv(rvec: torch.Tensor) -> torch.Tensor:
    theta2 = (rvec * rvec).sum(dim=-1, keepdim=True)
    K = hat(rvec)
    small = theta2 < 1e-8
    safe = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    half = safe * 0.5
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / (safe * safe),
    )
    return _eye3(rvec, K.shape) - 0.5 * K + cot_term[..., None] * (K @ K)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) tangent [rho, phi] → 4x4 homogeneous transform (batched)."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    t = (_left_jacobian(phi) @ rho[..., None])[..., 0]
    return se3_matrix(so3_exp(phi), t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 transform → SE(3) tangent [rho, phi]."""
    phi = so3_log(T[..., :3, :3])
    rho = (_left_jacobian_inv(phi) @ T[..., :3, 3][..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble 4x4 transforms from rotations and translations (batched)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[..., :1])], dim=-1)[..., None, :]  # no host copy
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_matrix(Rt, -(Rt @ T[..., :3, 3][..., None])[..., 0])


def se3_relative(T_i: torch.Tensor, T_j: torch.Tensor) -> torch.Tensor:
    """inv(T_i) @ T_j — the between-factor measurement model."""
    return se3_inverse(T_i) @ T_j


def se2_matrix(params: torch.Tensor) -> torch.Tensor:
    """[x, y, theta] → 3x3 homogeneous transform (batched)."""
    x, y, th = params[..., 0], params[..., 1], params[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    return torch.stack(
        [
            torch.stack([c, -s, x], dim=-1),
            torch.stack([s, c, y], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def se2_params(T: torch.Tensor) -> torch.Tensor:
    """3x3 transform → [x, y, theta]."""
    return torch.stack([T[..., 0, 2], T[..., 1, 2], torch.atan2(T[..., 1, 0], T[..., 0, 0])], dim=-1)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def sim3_matrix(params: torch.Tensor) -> torch.Tensor:
    """[t(3), rvec(3), log_s] → 4x4 similarity transform [[sR, t], [0, 1]]."""
    t, rvec, log_s = params[..., :3], params[..., 3:6], params[..., 6:7]
    return se3_matrix(torch.exp(log_s)[..., None] * so3_exp(rvec), t)


def sim3_params(S: torch.Tensor) -> torch.Tensor:
    """4x4 similarity → [t, rvec, log_s] (scale from the determinant)."""
    A = S[..., :3, :3]
    scale = torch.exp(torch.log(det3x3(A)[..., None]) / 3.0)
    R = A / scale[..., None]
    return torch.cat([S[..., :3, 3], so3_log(R), torch.log(scale)], dim=-1)


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    A_inv = inv3x3(S[..., :3, :3])
    return se3_matrix(A_inv, -(A_inv @ S[..., :3, 3][..., None])[..., 0])


def rotation_angle_deg(R: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation angle of R in degrees (batched)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.rad2deg(torch.acos(_clip((trace - 1.0) * 0.5, -1.0, 1.0)))
