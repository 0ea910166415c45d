"""Epipolar geometry: essential/homography solvers and decompositions.

Port of ``mvslam_tpu/geometry/epipolar.py``.
Everything is batched over leading axes (hypotheses, frames) and works in
normalised camera coordinates. The solvers and scorers take ``pinned``
(default True, as in the reference): the order-pinned forms are
elementwise only — explicit ``(m0·x0 + m1·x1) + m2·x2`` products, outer
products and :func:`~mvslam_tpu_torch.geometry.linalg.tree_sum` — with no
``matmul`` and no ``sum`` over a reduced axis, whose accumulation order
CUDA picks by shape and alignment. A hypothesis then gets the same bits
in a mesh block as in the whole batch. RANSAC picks the form by its
correspondence count (``ops.ransac._auto_pinned``); ``pinned=False`` is
the matmul and sum form it takes above 1,024 correspondences.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from mvslam_tpu_torch.geometry.linalg import det3x3, inv3x3, smallest_eigvec_psd, svd3x3, tree_sum
from mvslam_tpu_torch.geometry.projection import hartley_normalization

# Inverse-iteration counts for the null-space solves (the reference's
# values; fewer refit iterations measurably hurt near-degenerate pairs).
HYPOTHESIS_EIGVEC_ITERS = 10
REFIT_EIGVEC_ITERS = 10


def _homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def _matvec3(M: torch.Tensor, x: torch.Tensor, pinned: bool = True) -> torch.Tensor:
    """(..., 3, 3) applied to (..., N, 3) rows; ``pinned``: written out as
    ``(m0·x0 + m1·x1) + m2·x2`` per output row."""
    if not pinned:
        return x @ M.transpose(-1, -2)
    cols = [x[..., j] for j in range(3)]
    rows = [
        (M[..., i, 0, None] * cols[0] + M[..., i, 1, None] * cols[1]) + M[..., i, 2, None] * cols[2]
        for i in range(3)
    ]
    return torch.stack(rows, dim=-1)


def _mm3(A: torch.Tensor, B: torch.Tensor, pinned: bool = False) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3); ``pinned``: each entry written out as
    ``(a0·b0 + a1·b1) + a2·b2``."""
    if not pinned:
        return A @ B
    return (A[..., :, 0, None] * B[..., None, 0, :] + A[..., :, 1, None] * B[..., None, 1, :]) + (
        A[..., :, 2, None] * B[..., None, 2, :]
    )


def _gram_tree(A: torch.Tensor) -> torch.Tensor:
    """AᵀA (..., D, D) of A (..., N, D) as outer products summed by an
    order-pinned balanced tree over the rows (the reference's form)."""
    return tree_sum(A[..., :, :, None] * A[..., :, None, :], -3)


def _smallest_singular_vector(
    A: torch.Tensor, rescue: bool = True, iterations: int = HYPOTHESIS_EIGVEC_ITERS, pinned: bool = True
) -> torch.Tensor:
    """Right singular vector of A (..., R, D) with the smallest singular
    value: inverse iteration on AᵀA (``pinned``: :func:`_gram_tree`)."""
    gram = _gram_tree(A) if pinned else A.transpose(-1, -2) @ A
    return smallest_eigvec_psd(gram, iterations=iterations, rescue=rescue, pinned=pinned)


def essential_rows(
    pts1: torch.Tensor, pts2: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """(..., N, 9) rows ``kron(x2, x1)`` of the 8-point system x2ᵀ E x1 = 0."""
    x1 = _homogeneous(pts1)
    x2 = _homogeneous(pts2)
    A = (x2[..., :, :, None] * x1[..., :, None, :]).reshape(*x1.shape[:-1], 9)
    if weights is not None:
        A = A * weights[..., None]
    return A


def _invsqrt3x3_psd(C: torch.Tensor, iterations: int = 5, pinned: bool = False) -> torch.Tensor:
    """Newton–Schulz C^(−1/2) for (..., 3, 3) SPD with spectrum ⊂ (0, 3)."""
    eye = torch.eye(3, dtype=C.dtype, device=C.device).expand(C.shape)
    X = eye
    for _ in range(iterations):
        X = 0.5 * _mm3(X, 3.0 * eye - _mm3(C, _mm3(X, X, pinned), pinned), pinned)
    return X


def essential_from_vec(e: torch.Tensor, exact_rank2: bool, pinned: bool = False) -> torch.Tensor:
    """E (..., 3, 3) from the null-space vector (..., 9).

    ``exact_rank2=False`` (hypothesis batches): only project out the
    smallest right-singular direction, E(I − v₃v₃ᵀ) (Sampson scoring is
    scale-invariant). ``exact_rank2=True`` (refits): the full σ = (1, 1, 0)
    spectrum via (E₂/σ̂)·C^(−1/2) with C = E₂ᵀE₂/σ̂² + v₃v₃ᵀ (see the
    reference for the derivation). ``pinned``: every 3×3 product written
    out (:func:`_mm3`).
    """
    E = e.reshape(*e.shape[:-1], 3, 3)
    Et = E.transpose(-1, -2)
    v3 = smallest_eigvec_psd(
        _mm3(Et, E, pinned),
        iterations=HYPOTHESIS_EIGVEC_ITERS if not exact_rank2 else REFIT_EIGVEC_ITERS,
        rescue=False,
        pinned=pinned,
    )
    Ev3 = _matvec3(E, v3[..., None, :], pinned).transpose(-1, -2) if pinned else E @ v3[..., :, None]
    E2 = E - Ev3 * v3[..., None, :]
    if not exact_rank2:
        return E2
    A = _mm3(E2.transpose(-1, -2), E2, pinned)
    s2 = (0.5 * ((A[..., 0, 0] + A[..., 1, 1]) + A[..., 2, 2])).clamp_min(1e-20)
    C = A / s2[..., None, None] + v3[..., :, None] * v3[..., None, :]
    C = C + 1e-6 * torch.eye(3, dtype=E.dtype, device=E.device)
    return _mm3(E2 / torch.sqrt(s2)[..., None, None], _invsqrt3x3_psd(C, pinned=pinned), pinned)


def eight_point_essential(
    pts1: torch.Tensor, pts2: torch.Tensor, weights: torch.Tensor | None = None, pinned: bool = True
) -> torch.Tensor:
    """Essential matrix from ≥ 8 normalised correspondences (..., N, 2).

    Optional ``weights`` (..., N) scale each constraint row (an inlier
    mask refits on inliers without dynamic shapes); a refit takes the
    rescued null-space solve and the full σ = (1, 1, 0) spectrum, a
    hypothesis batch neither. ``pinned``: the order-pinned forms.
    """
    refit = weights is not None
    e = _smallest_singular_vector(
        essential_rows(pts1, pts2, weights),
        rescue=refit,
        iterations=REFIT_EIGVEC_ITERS if refit else HYPOTHESIS_EIGVEC_ITERS,
        pinned=pinned,
    )
    return essential_from_vec(e, exact_rank2=refit, pinned=pinned)


def sampson_error(E: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor, pinned: bool = True) -> torch.Tensor:
    """First-order geometric (Sampson) error of x2ᵀ E x1: (..., N) squared."""
    x1 = _homogeneous(pts1)
    x2 = _homogeneous(pts2)
    Ex1 = _matvec3(E, x1, pinned)
    Etx2 = _matvec3(E.transpose(-1, -2), x2, pinned)
    prod = x2 * Ex1
    num = ((prod[..., 0] + prod[..., 1]) + prod[..., 2]) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.where(den < 1e-12, torch.full_like(den, 1e-12), den)


def _two_ray_depths(R, t_vec, pts1, pts2):
    """Per-point depths (z1, z2) from the 2x2 normal equations of
    [f2 | -R f1] [z2; z1] = t (cam1 at identity).

    R (..., 3, 3), t_vec (..., 3), pts (..., N, 2) → (..., N) each.
    """
    f1 = _homogeneous(pts1)
    f2 = _homogeneous(pts2)
    f2, Rf1 = torch.broadcast_tensors(f2, f1 @ R.transpose(-1, -2))
    A = torch.stack([f2, -Rf1], dim=-1)  # (..., N, 3, 2)
    b = t_vec[..., None, :, None].expand(A.shape[:-1] + (1,))  # (..., N, 3, 1)
    AtA = A.transpose(-1, -2) @ A  # (..., N, 2, 2)
    Atb = A.transpose(-1, -2) @ b  # (..., N, 2, 1)
    det = AtA[..., 0, 0] * AtA[..., 1, 1] - AtA[..., 0, 1] * AtA[..., 1, 0]
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    z2 = (AtA[..., 1, 1] * Atb[..., 0, 0] - AtA[..., 0, 1] * Atb[..., 1, 0]) / det
    z1 = (-AtA[..., 1, 0] * Atb[..., 0, 0] + AtA[..., 0, 0] * Atb[..., 1, 0]) / det
    return z1, z2


def _take(x: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """x[..., idx, ...] along ``dim`` (negative, counted on x) for a batch
    index tensor ``idx`` of shape x.shape[:dim]."""
    tail = x.shape[dim + 1 :] if dim != -1 else ()
    index = idx.reshape(*idx.shape, 1, *([1] * len(tail))).expand(*idx.shape, 1, *tail)
    return torch.gather(x, dim, index).squeeze(dim)


def decompose_essential(
    E: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Recover (R, t) from E (..., 3, 3) by cheirality voting over the 4
    candidates on pts (..., N, 2). Returns (R, unit t, cheirality count).

    The rotation pair comes from Horn's closed form R = adj(E)ᵀ ∓ [t]×E on
    E rescaled to ‖E‖_F = √2, then one Newton orthonormalisation step.
    """
    fnorm = torch.sqrt((E * E).sum(dim=(-2, -1)))
    En = E * (math.sqrt(2.0) / fnorm.clamp_min(1e-20))[..., None, None]
    t = smallest_eigvec_psd(En @ En.transpose(-1, -2), iterations=REFIT_EIGVEC_ITERS, rescue=True)
    a, b, c = En[..., 0, 0], En[..., 0, 1], En[..., 0, 2]
    d, e, f = En[..., 1, 0], En[..., 1, 1], En[..., 1, 2]
    g, h, i = En[..., 2, 0], En[..., 2, 1], En[..., 2, 2]
    cof = torch.stack(
        [
            torch.stack([e * i - f * h, f * g - d * i, d * h - e * g], dim=-1),
            torch.stack([c * h - b * i, a * i - c * g, b * g - a * h], dim=-1),
            torch.stack([b * f - c * e, c * d - a * f, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )  # adj(En)ᵀ
    zero = torch.zeros_like(t[..., 0])
    skew_t = torch.stack(
        [
            torch.stack([zero, -t[..., 2], t[..., 1]], dim=-1),
            torch.stack([t[..., 2], zero, -t[..., 0]], dim=-1),
            torch.stack([-t[..., 1], t[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )
    txE = skew_t @ En
    eye3 = torch.eye(3, dtype=E.dtype, device=E.device)

    def _orthonormalize(R):
        return R @ (1.5 * eye3 - 0.5 * (R.transpose(-1, -2) @ R))

    R1 = _orthonormalize(cof - txE)
    R2 = _orthonormalize(cof + txE)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)  # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=-2)  # (..., 4, 3)
    z1, z2 = _two_ray_depths(Rs, ts, pts1[..., None, :, :], pts2[..., None, :, :])
    good = ((z1 > 1e-6) & (z2 > 1e-6)).to(E.dtype)  # (..., 4, N)
    if weights is not None:
        good = good * weights[..., None, :]
    counts = good.sum(dim=-1)
    best = torch.argmax(counts, dim=-1)  # first maximum, like jnp.argmax
    R_best = _take(Rs, best, -3)
    t_best = _take(ts, best, -2)
    t_norm = torch.sqrt((t_best * t_best).sum(dim=-1, keepdim=True))
    t_best = t_best / torch.where(t_norm < 1e-12, torch.full_like(t_norm, 1e-12), t_norm)
    return R_best, t_best, _take(counts, best, -1)


def triangulate_normalized(
    R: torch.Tensor, t: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor
) -> torch.Tensor:
    """Two-ray linear triangulation (cam1 at identity): (..., N, 3) in cam1."""
    z1, _ = _two_ray_depths(R, t, pts1, pts2)
    return _homogeneous(pts1) * z1[..., None]


def homography_rows(
    pts1: torch.Tensor, pts2: torch.Tensor, weights: torch.Tensor | None = None, pinned: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hartley-normalised DLT constraint rows: ((..., 2N, 9), T1, T2)."""
    n1, T1 = hartley_normalization(pts1, weights, pinned=pinned)
    n2, T2 = hartley_normalization(pts2, weights, pinned=pinned)
    x, y = n1[..., 0], n1[..., 1]
    u, v = n2[..., 0], n2[..., 1]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    row1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], dim=-1)
    row2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], dim=-1)
    if weights is not None:
        row1 = row1 * weights[..., None]
        row2 = row2 * weights[..., None]
    return torch.cat([row1, row2], dim=-2), T1, T2


def homography_from_vec(h: torch.Tensor, T1: torch.Tensor, T2: torch.Tensor, pinned: bool = False) -> torch.Tensor:
    """H (..., 3, 3) from the null-space vector (..., 9), denormalised,
    scaled to H[2, 2] = 1."""
    Hn = h.reshape(*h.shape[:-1], 3, 3)
    H = _mm3(_mm3(inv3x3(T2), Hn, pinned), T1, pinned)
    scale = H[..., 2:3, 2:3]
    return H / torch.where(scale.abs() < 1e-12, torch.full_like(scale, 1e-12), scale)


def dlt_homography(
    pts1: torch.Tensor, pts2: torch.Tensor, weights: torch.Tensor | None = None, pinned: bool = True
) -> torch.Tensor:
    """Hartley-normalised DLT homography from ≥ 4 correspondences
    (..., N, 2), scaled to H[2, 2] = 1; ``weights`` and ``pinned`` as in
    :func:`eight_point_essential`."""
    A, T1, T2 = homography_rows(pts1, pts2, weights, pinned=pinned)
    refit = weights is not None
    h = _smallest_singular_vector(
        A, rescue=refit, iterations=REFIT_EIGVEC_ITERS if refit else HYPOTHESIS_EIGVEC_ITERS, pinned=pinned
    )
    return homography_from_vec(h, T1, T2, pinned=pinned)


def symmetric_transfer_error(
    H: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor, pinned: bool = True
) -> torch.Tensor:
    """Forward + backward squared transfer error of a homography: (..., N)."""
    H_inv = inv3x3(H)

    def transfer(M, pts):
        y = _matvec3(M, _homogeneous(pts), pinned)
        w = y[..., 2:3]
        w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
        return y[..., :2] / w

    fwd = transfer(H, pts1) - pts2
    bwd = transfer(H_inv, pts2) - pts1
    if pinned:
        return (fwd[..., 0] * fwd[..., 0] + fwd[..., 1] * fwd[..., 1]) + (
            bwd[..., 0] * bwd[..., 0] + bwd[..., 1] * bwd[..., 1]
        )
    return (fwd * fwd).sum(dim=-1) + (bwd * bwd).sum(dim=-1)


def _sign_pairs(dtype, device) -> torch.Tensor:
    """(4, 2): the rows (+1, +1), (+1, -1), (-1, +1), (-1, -1), made by
    fills on ``device`` (no host-to-device copy, so a CUDA graph can
    capture it)."""
    signs = torch.ones((4, 2), dtype=dtype, device=device)
    signs[2:, 0] = -1.0
    signs[1::2, 1] = -1.0
    return signs


def decompose_homography(
    H: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Calibrated homography (..., 3, 3) → (R, unit t, cheirality count).

    Faugeras decomposition on the closed-form SVD H = U·diag(d1, d2, d3)·Vᵀ
    (reflections folded into U and V): four sign combinations of
    x1 = ±√((d1²−d2²)/(d1²−d3²)), x3 = ±√((d2²−d3²)/(d1²−d3²)) give
    candidate (R, t), ranked by cheirality voting over the correspondences.
    """
    U, S, Vt = svd3x3(H)
    U = U * det3x3(U)[..., None, None]
    Vt = Vt * det3x3(Vt)[..., None, None]
    d1, d2, d3 = S[..., 0], S[..., 1], S[..., 2]
    denom = (d1 * d1 - d3 * d3).clamp_min(1e-12)
    x1 = torch.sqrt(((d1 * d1 - d2 * d2) / denom).clamp(0.0, 1.0))
    x3 = torch.sqrt(((d2 * d2 - d3 * d3) / denom).clamp(0.0, 1.0))
    d2_safe = d2.clamp_min(1e-12)

    signs = _sign_pairs(H.dtype, H.device)
    e1, e3 = signs[:, 0], signs[:, 1]  # (4,)
    d1_, d3_, x1_, x3_, d2s = (v[..., None] for v in (d1, d3, x1, x3, d2_safe))  # (..., 1)
    s_theta = (d1_ - d3_) * (e1 * x1_) * (e3 * x3_) / d2s  # (..., 4)
    c_theta = ((d1_ * x3_ * x3_ + d3_ * x1_ * x1_) / d2s).expand_as(s_theta)
    zero = torch.zeros_like(s_theta)
    one = torch.ones_like(s_theta)
    Rp = torch.stack(
        [
            torch.stack([c_theta, zero, -s_theta], dim=-1),
            torch.stack([zero, one, zero], dim=-1),
            torch.stack([s_theta, zero, c_theta], dim=-1),
        ],
        dim=-2,
    )  # (..., 4, 3, 3)
    tp = (d1_ - d3_)[..., None] * torch.stack([e1 * x1_, zero, -e3 * x3_], dim=-1)  # (..., 4, 3)
    Rs = U[..., None, :, :] @ Rp @ Vt[..., None, :, :]
    ts = (U[..., None, :, :] @ tp[..., :, None])[..., 0]

    norm = torch.sqrt((ts * ts).sum(dim=-1, keepdim=True))
    t_unit = ts / torch.where(norm < 1e-9, torch.ones_like(norm), norm)
    pts = triangulate_normalized(Rs, t_unit, pts1[..., None, :, :], pts2[..., None, :, :])
    z1 = pts[..., 2]
    cam2 = pts @ Rs.transpose(-1, -2) + t_unit[..., None, :]
    counts = ((z1 > 1e-6) & (cam2[..., 2] > 1e-6)).sum(dim=-1)  # (..., 4)
    best = torch.argmax(counts, dim=-1)  # first maximum, like jnp.argmax
    R_best = _take(Rs, best, -3)
    t_best = _take(ts, best, -2)
    t_norm = torch.sqrt((t_best * t_best).sum(dim=-1, keepdim=True))
    t_best = t_best / torch.where(t_norm < 1e-9, torch.ones_like(t_norm), t_norm)
    return R_best, t_best, _take(counts, best, -1)
