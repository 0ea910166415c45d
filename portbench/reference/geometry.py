"""Plain reference of two-view geometry: the essential matrix by RANSAC over
8-point samples with least-squares refits, its decomposition by
cheirality, the support of any relative pose, and the recount of the
inliers a pose states.

A pose (R, t) maps the first camera's coordinates to the second's:
X2 = R X1 + t. The support of a pose is the number of matches whose
Sampson distance to E = [t]x R, in pixels, lies under the chi-square 95%
cutoff of the pixel threshold the configuration states (1.5 px, scaled by
the median match displacement over 25, clipped to 0.5-2). Float64 unless
``dtype`` says otherwise; ``dtype=torch.bfloat16`` rounds every input of
the solves to bfloat16 (the lower-precision control).
"""

from __future__ import annotations

import numpy as np
import torch


def skew(t: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(t[..., 0])
    return torch.stack(
        [
            torch.stack([z, -t[..., 2], t[..., 1]], -1),
            torch.stack([t[..., 2], z, -t[..., 0]], -1),
            torch.stack([-t[..., 1], t[..., 0], z], -1),
        ],
        -2,
    )


def normalise(px: torch.Tensor, K: np.ndarray) -> torch.Tensor:
    Kt = torch.as_tensor(K, dtype=torch.float64, device=px.device)
    return torch.stack([(px[..., 0] - Kt[0, 2]) / Kt[0, 0], (px[..., 1] - Kt[1, 2]) / Kt[1, 1]], -1)


def sampson_sq(E: torch.Tensor, n1: torch.Tensor, n2: torch.Tensor) -> torch.Tensor:
    """(..., N) squared Sampson distances of matches under E (..., 3, 3)."""
    x1 = torch.cat([n1, torch.ones_like(n1[..., :1])], -1)
    x2 = torch.cat([n2, torch.ones_like(n2[..., :1])], -1)
    Ex1 = x1 @ E.transpose(-1, -2)
    Etx2 = x2 @ E
    num = (x2 * Ex1).sum(-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / den.clamp_min(1e-30)


def cutoff_px2(p1: torch.Tensor, p2: torch.Tensor, base_px: float) -> float:
    """The chi-square 95% cutoff (px²) of the adaptive threshold."""
    disp = torch.linalg.norm(p2 - p1, dim=-1)
    med = float(torch.sort(disp).values[(len(disp) - 1) // 2]) if len(disp) else 25.0
    thr = base_px * min(max(med / 25.0, 0.5), 2.0)
    return 3.84 * (thr / 1.96) ** 2


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype == torch.float64 else x.to(dtype).to(torch.float64)


def _eight_point(n1, n2, w, dtype):
    """Essential matrices from weighted point sets (..., N, 2): the null
    vector of the epipolar constraints, projected to singular values
    (1, 1, 0)."""
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], -1)
    A = _round(A * w[..., None], dtype)
    AtA = _round(A.transpose(-1, -2) @ A, dtype)
    _, vecs = torch.linalg.eigh(AtA)
    E = _round(vecs[..., 0].reshape(*vecs.shape[:-2], 3, 3), dtype)
    U, _, Vh = torch.linalg.svd(E)
    d = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return U @ torch.diag_embed(d.expand(*E.shape[:-2], 3)) @ Vh


def decompose(E, n1, n2, inliers):
    """The (R, t) of E's four that puts most inlier points in front of both
    cameras (midpoint triangulation)."""
    U, _, Vh = torch.linalg.svd(E)
    if torch.det(U) < 0:
        U = -U
    if torch.det(Vh) < 0:
        Vh = -Vh
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    best, best_count = None, -1
    x1 = torch.cat([n1, torch.ones_like(n1[:, :1])], -1)[inliers]
    x2 = torch.cat([n2, torch.ones_like(n2[:, :1])], -1)[inliers]
    for R in (U @ W @ Vh, U @ W.T @ Vh):
        for t in (U[:, 2], -U[:, 2]):
            # Depths d1, d2 with d2 x2 = d1 R x1 + t, least squares.
            a = x1 @ R.T
            aa, bb, ab = (a * a).sum(-1), (x2 * x2).sum(-1), (a * x2).sum(-1)
            at, bt = a @ t, x2 @ t
            det = (aa * bb - ab * ab).clamp_min(1e-30)
            d1 = (ab * bt - bb * at) / det
            d2 = (aa * bt - ab * at) / det
            count = int(((d1 > 0) & (d2 > 0)).sum())
            if count > best_count:
                best, best_count = (R, t), count
    return best


def pose_sampson_sq(R, t, n1, n2) -> torch.Tensor:
    """Squared Sampson distances of the matches under E = [t]x R."""
    t = t / torch.linalg.norm(t).clamp_min(1e-12)
    return sampson_sq(skew(t) @ R, n1, n2)


def support(R, t, n1, n2, cutoff_norm2) -> int:
    return int((pose_sampson_sq(R, t, n1, n2) < cutoff_norm2).sum())


def recount(R, t, p1, p2, K, base_px, dtype=torch.float64) -> int:
    """The matches (pixels, (N, 2) each) whose squared Sampson distance
    under E = [t]x R, in normalised units, lies under the square of the
    threshold the configuration states: ``base_px`` scaled by the median
    match displacement over 25 (the mean of the two middle values on an
    even count), clipped to 0.5-2, over fx. A pose with no translation
    supports none."""
    if len(p1) == 0 or float(torch.linalg.norm(t)) < 1e-9:
        return 0
    disp = torch.sort(torch.linalg.norm(p2.to(torch.float64) - p1.to(torch.float64), dim=-1)).values
    n = len(disp)
    med = float(0.5 * (disp[(n - 1) // 2] + disp[n // 2]))
    thr = base_px * min(max(med / 25.0, 0.5), 2.0) / float(K[0][0])
    n1 = _round(normalise(p1.to(torch.float64), K), dtype)
    n2 = _round(normalise(p2.to(torch.float64), K), dtype)
    R = torch.as_tensor(R, dtype=torch.float64, device=n1.device)
    t = torch.as_tensor(t, dtype=torch.float64, device=n1.device)
    return int((pose_sampson_sq(R, t, n1, n2) < thr * thr).sum())


def residuals(R, t, R_ref, t_ref, n1, n2, cutoff_norm2):
    """Median Sampson distances (normalised units) of the matches the
    reference's pose supports, under (R, t) and under the reference's
    pose; None where it supports none."""
    inliers = pose_sampson_sq(R_ref, t_ref, n1, n2) < cutoff_norm2
    if int(inliers.sum()) == 0:
        return None
    ref = torch.sqrt(pose_sampson_sq(R_ref, t_ref, n1, n2)[inliers]).median()
    got = torch.sqrt(pose_sampson_sq(R, t, n1, n2)[inliers]).median()
    return float(got), float(ref)


def relative_pose(p1, p2, K, base_px, generator, hypotheses=2048, refits=2, dtype=torch.float64):
    """RANSAC over ``hypotheses`` 8-point samples of the matches (pixels,
    (N, 2) each); the best refit on its inliers ``refits`` times. Returns
    (R, t, support, cutoff in normalised units²) or None with fewer than 8
    matches."""
    n = len(p1)
    if n < 8:
        return None
    p1 = p1.to(torch.float64)
    p2 = p2.to(torch.float64)
    n1, n2 = _round(normalise(p1, K), dtype), _round(normalise(p2, K), dtype)
    fx = float(K[0][0])
    cut = cutoff_px2(p1, p2, base_px) / fx**2
    idx = torch.argsort(torch.rand((hypotheses, n), generator=generator, device=generator.device), 1)[:, :8]
    idx = idx.to(p1.device)
    E = _eight_point(n1[idx], n2[idx], torch.ones(idx.shape, dtype=torch.float64, device=p1.device), dtype)
    votes = (sampson_sq(E, n1[None], n2[None]) < cut).sum(-1)
    best = E[int(torch.argmax(votes))]
    inl = sampson_sq(best, n1, n2) < cut
    for _ in range(refits):
        if int(inl.sum()) < 8:
            break
        refit = _eight_point(n1, n2, inl.to(torch.float64), dtype)
        new_inl = sampson_sq(refit, n1, n2) < cut
        if int(new_inl.sum()) >= int(inl.sum()):
            best, inl = refit, new_inl
    R, t = decompose(best, n1, n2, inl)
    return R, t, support(R, t, n1, n2, cut), cut
