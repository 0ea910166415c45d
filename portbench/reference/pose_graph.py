"""Plain reference of the SE(3) pose graph that corrects a keyframe chain
after a loop closes.

Written from the equations. A pose is the world-from-camera transform T,
its parameters [t, r] (translation, rotation vector: T = [exp([r]x) | t]).
An edge (i, j) with measured transform M and weight w has the residual

    r_ij = w * log(M^-1 T_i^-1 T_j)

in se(3) as [rho, phi] (phi the rotation vector of the error's rotation,
rho = V(phi)^-1 times its translation, V the left Jacobian of SO(3)). The
cost is 1/2 sum rho(|r_ij|^2) under Huber's loss of scale c:
rho(s) = s where s <= c^2, else 2 c sqrt(s) - c^2; each iteration weighs
an edge by rho'(s) (iteratively reweighted least squares). Gauss-Newton:
the Jacobians of each residual with respect to the parameters of both its
poses, the normal equations with the first pose anchored (its rows and
columns out, 1 on its diagonal), ``DAMPING`` added on the diagonal of the
others, a Cholesky solve, the step added to the parameters, and kept only
where the cost falls; the first step not kept, or one shorter than 1e-8,
or a gradient under 1e-10, ends the solve.

The chain's edges are the odometry between consecutive poses (weight 1),
the loop edge has its own weight. Plain PyTorch, float64 by default, with
TF32 off; nothing of the program. Departures from the program's solver
(``mvslam_tpu_torch/backend``), none of which changes the solution beyond
rounding:

- the starting parameters are read from each pose, where the program
  composes them from the first pose and the odometry on the host;
- an edge's measurement is the transform itself, where the program carries
  it as parameters;
- the rotation's log goes through a unit quaternion, where the program
  takes the axis from the antisymmetric part and handles angles near pi
  apart;
- Jacobians by ``torch.func.jacfwd`` of each residual, the normal equations
  assembled by accumulating 6 x 6 blocks, in no fixed order of the edges;
- the program solves in float32; this in float64 (``dtype`` chooses: a
  lower precision rounds every stored value, the parameters, the
  residuals, the Jacobians, the normal equations and the step, to it, as
  a program computing in it would).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from portbench.reference.geometry import skew as hat

ITERATIONS = 15
DAMPING = 1e-4
HUBER = 1.0  # the loss's scale c
STEP_TOLERANCE = 1e-8
GRADIENT_TOLERANCE = 1e-10


def _theta(v):
    """|v|^2, and |v| guarded where it is 0 (a smooth stand-in there)."""
    t2 = (v * v).sum(-1)
    small = t2 < 1e-12
    return t2, small, torch.sqrt(torch.where(small, torch.ones_like(t2), t2))


def exp_so3(r):
    """Rodrigues: I + sin(t)/t [r]x + (1 - cos(t))/t^2 [r]x^2."""
    t2, small, t = _theta(r)
    a = torch.where(small, 1 - t2 / 6, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(t)) / t2.where(~small, torch.ones_like(t2)))
    K = hat(r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def _quaternion(R):
    """The unit quaternion (w, x, y, z), w >= 0, of a rotation matrix:
    each of Shepperd's four forms, the one with the largest divisor taken."""
    m00, m11, m22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    d = torch.stack([tr, m00, m11, m22], -1)
    k = torch.argmax(d, -1)
    s = [torch.sqrt(torch.clamp(1 + 2 * d[..., i] - tr, min=1e-30)) * 2 for i in range(4)]
    forms = [
        torch.stack([s[0] / 4, (R[..., 2, 1] - R[..., 1, 2]) / s[0], (R[..., 0, 2] - R[..., 2, 0]) / s[0], (R[..., 1, 0] - R[..., 0, 1]) / s[0]], -1),
        torch.stack([(R[..., 2, 1] - R[..., 1, 2]) / s[1], s[1] / 4, (R[..., 0, 1] + R[..., 1, 0]) / s[1], (R[..., 0, 2] + R[..., 2, 0]) / s[1]], -1),
        torch.stack([(R[..., 0, 2] - R[..., 2, 0]) / s[2], (R[..., 0, 1] + R[..., 1, 0]) / s[2], s[2] / 4, (R[..., 1, 2] + R[..., 2, 1]) / s[2]], -1),
        torch.stack([(R[..., 1, 0] - R[..., 0, 1]) / s[3], (R[..., 0, 2] + R[..., 2, 0]) / s[3], (R[..., 1, 2] + R[..., 2, 1]) / s[3], s[3] / 4], -1),
    ]
    q = torch.stack(forms, -2)
    q = torch.gather(q, -2, k[..., None, None].expand(*k.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def log_so3(R):
    """The rotation vector 2 atan2(|v|, w) v / |v| of R's quaternion (w, v)."""
    q = _quaternion(R)
    w, v = q[..., 0], q[..., 1:]
    n2, small, n = _theta(v)
    f = torch.where(small, 2 / w * (1 - n2 / (3 * w * w)), 2 * torch.atan2(n, w) / n)
    return v * f[..., None]


def log_se3(T):
    """[rho, phi] of a 4 x 4 transform: phi = log(R), rho = V(phi)^-1 t,
    V^-1 = I - [phi]x / 2 + (1/t^2 - (1 + cos t) / (2 t sin t)) [phi]x^2."""
    phi = log_so3(T[..., :3, :3])
    t2, small, t = _theta(phi)
    safe = t2.where(~small, torch.ones_like(t2))
    c = torch.where(small, 1 / 12 + t2 / 720, 1 / safe - (1 + torch.cos(t)) / (2 * t * torch.sin(t)))
    K = hat(phi)
    eye = torch.eye(3, dtype=T.dtype, device=T.device).expand(K.shape)
    Vinv = eye - 0.5 * K + c[..., None, None] * (K @ K)
    return torch.cat([(Vinv @ T[..., :3, 3, None])[..., 0], phi], -1)


def transform(x):
    """Parameters [t, r] -> 4 x 4 transforms."""
    top = torch.cat([exp_so3(x[..., 3:]), x[..., :3, None]], -1)
    bottom = torch.cat([torch.zeros_like(x[..., :3]), torch.ones_like(x[..., :1])], -1)[..., None, :]
    return torch.cat([top, bottom], -2)


def params(T):
    return torch.cat([T[..., :3, 3], log_so3(T[..., :3, :3])], -1)


def inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ T[..., :3, 3, None])], -1)
    return torch.cat([top, T[..., 3:, :]], -2)


def residual(xi, xj, M_inv, w):
    return w * log_se3(M_inv @ inverse(transform(xi)) @ transform(xj))


def _round(x, dtype):
    return x if dtype == torch.float64 else x.to(dtype).to(torch.float64)


def solve_chain(poses, loop_nodes, loop_edge, loop_weight: float, device="cpu", dtype=torch.float64):
    """The corrected poses (N, 4, 4) of a chain of world-from-camera poses
    (N, 4, 4) with odometry edges between neighbours (weight 1) and one
    loop edge ``loop_edge`` (4 x 4, from node ``loop_nodes[0]`` to
    ``loop_nodes[1]``) of weight ``loop_weight``; the first pose anchored."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    P = torch.as_tensor(np.asarray(poses, np.float64), device=device)
    n = P.shape[0]
    i = torch.cat([torch.arange(n - 1), torch.tensor([int(loop_nodes[0])])]).to(device)
    j = torch.cat([torch.arange(1, n), torch.tensor([int(loop_nodes[1])])]).to(device)
    M = torch.cat([inverse(P[:-1]) @ P[1:], torch.as_tensor(np.asarray(loop_edge, np.float64), device=device)[None]])
    M_inv = _round(inverse(M), dtype)
    w = torch.ones(n, dtype=torch.float64, device=device)
    w[-1] = loop_weight
    x = _round(params(P), dtype)
    c2 = HUBER**2
    rows = 6 * i[:, None] + torch.arange(6, device=device)
    cols = 6 * j[:, None] + torch.arange(6, device=device)
    free = torch.ones(6 * n, dtype=torch.float64, device=device)
    free[:6] = 0

    def residuals(x):
        return _round(vmap(residual)(x[i], x[j], M_inv, w), dtype)

    def cost(r):
        s = (r * r).sum(-1)
        return 0.5 * torch.where(s <= c2, s, 2 * HUBER * torch.sqrt(s) - c2).sum()

    jac = vmap(jacfwd(residual, argnums=(0, 1)))
    for _ in range(ITERATIONS):
        r = residuals(x)
        Ji, Jj = (_round(J, dtype) for J in jac(x[i], x[j], M_inv, w))
        s = (r * r).sum(-1)
        irls = torch.where(s <= c2, torch.ones_like(s), HUBER / torch.sqrt(s))
        H = torch.zeros(6 * n, 6 * n, dtype=torch.float64, device=device)
        g = torch.zeros(6 * n, dtype=torch.float64, device=device)
        for A, ra in ((Ji, rows), (Jj, cols)):
            g.index_put_((ra.reshape(-1),), (torch.einsum("eki,ek,e->ei", A, r, irls)).reshape(-1), accumulate=True)
            for B, cb in ((Ji, rows), (Jj, cols)):
                block = torch.einsum("eki,ekj,e->eij", A, B, irls)
                H.index_put_((ra[:, :, None].expand_as(block).reshape(-1), cb[:, None, :].expand_as(block).reshape(-1)), block.reshape(-1), accumulate=True)
        diagonal = torch.where(free > 0, torch.full_like(free, DAMPING), torch.ones_like(free))
        H = _round(H * free[:, None] * free[None, :] + torch.diag(diagonal), dtype)
        b = _round(-g * free, dtype)
        L, info = torch.linalg.cholesky_ex(H)
        if int(info) != 0:  # not positive definite (in a low precision): no step
            break
        step = _round(torch.cholesky_solve(b[:, None], L)[:, 0] * free, dtype)
        x_new = _round(x + step.reshape(n, 6), dtype)
        taken = bool(cost(residuals(x_new)) < cost(r))
        if taken:
            x = x_new
        if not taken or float(torch.linalg.vector_norm(step)) < STEP_TOLERANCE or float(torch.linalg.vector_norm(b)) < GRADIENT_TOLERANCE:
            break
    return transform(x).cpu().numpy()
