"""Batched small-matrix linear algebra in closed form.

Port of ``mvslam_tpu/geometry/linalg.py``: adjugate inverses, Cardano
eigendecompositions and inverse iteration instead of iterative LAPACK
routines, so thousands of tiny systems (a RANSAC hypothesis batch) run as
a handful of batched elementwise ops. All functions take any leading batch
axes. Reductions are plain sums, unless a caller asks for the order-pinned
form (``pinned=True``, :func:`tree_sum`): a mesh splits a batch into
blocks, and on CUDA the order in which ``sum`` and ``matmul`` accumulate
follows the shape and alignment of their input, so only elementwise
arithmetic gives a hypothesis the same bits in a block as in the batch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` as an explicit balanced tree of slice adds.

    The order of a reduction kernel's additions is the library's choice and
    changes with the input's shape (a mesh block is a slice of the batch);
    the pairwise adds here fix it in the program itself, so a row sums to
    the same bits in any batch, on any device. Zero-padded to the next
    power of two; roundoff O(log N · eps).
    """
    dim = dim % x.ndim
    n = x.shape[dim]
    if n <= 1:
        return x.sum(dim=dim)
    m = 1 << (n - 1).bit_length()  # next power of two >= n
    if m != n:
        pad = list(x.shape)
        pad[dim] = m - n
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    while m > 1:
        m //= 2
        x = x.narrow(dim, 0, m) + x.narrow(dim, m, m)
    return x.squeeze(dim)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3) matrices."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F_ = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    # Sign-preserving clamp: a tiny NEGATIVE det must clamp to -1e-30, or
    # the inverse comes back globally sign-flipped.
    tiny = torch.where(det < 0, torch.full_like(det, -1e-30), torch.full_like(det, 1e-30))
    det = torch.where(det.abs() < 1e-30, tiny, det)
    adj = torch.stack(
        [torch.stack([A, B, C], dim=-1), torch.stack([D, E, F_], dim=-1), torch.stack([G, H, I], dim=-1)],
        dim=-2,
    )
    return adj / det[..., None, None]


def det3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3) matrices."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) + b * (f * g - d * i) + c * (d * h - e * g)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _unit_or(v: torch.Tensor, fallback: torch.Tensor, threshold: float) -> torch.Tensor:
    n = torch.sqrt((v * v).sum(dim=-1, keepdim=True))
    return torch.where(n > threshold, v / n.clamp_min(1e-30), fallback)


def _perpendicular(anchor: torch.Tensor) -> torch.Tensor:
    """Unit vector perpendicular to ``anchor`` from the axis least aligned
    with it (fallback basis completion)."""
    axis = F.one_hot(anchor.abs().argmin(dim=-1), 3).to(anchor.dtype)
    fb = axis - anchor * (anchor * axis).sum(dim=-1, keepdim=True)
    return fb / torch.sqrt((fb * fb).sum(dim=-1, keepdim=True)).clamp_min(1e-30)


def eigh3x3(A: torch.Tensor):
    """Closed-form eigendecomposition of symmetric (..., 3, 3) matrices.

    Returns ``(eigvals (..., 3) descending, eigvecs (..., 3, 3) columns)``:
    eigenvalues by the trigonometric solution of the characteristic cubic,
    eigenvectors by the largest cross product of rows of (A − λI), the
    middle one completed as v₃ × v₁. Degenerate spectra yield an arbitrary
    orthonormal basis of the degenerate subspace.
    """
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(dim=-1) / 3.0
    eye = _eye(3, A)
    Aq = A - q[..., None, None] * eye
    p2 = (Aq * Aq).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(p2.clamp_min(1e-30))
    B = Aq / p[..., None, None]
    r = (0.5 * det3x3(B)).clamp(-1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3

    def _null_vec(lam):
        M = A - lam[..., None, None] * eye
        r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
        cands = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], dim=-2)
        best = (cands * cands).sum(dim=-1).argmax(dim=-1)
        v = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
        e0 = torch.zeros_like(v)
        e0[..., 0] = 1.0
        return _unit_or(v, e0, 1e-20)

    v1 = _null_vec(lam1)
    v3 = _null_vec(lam3)

    def _orth(v, anchor):
        # Gram-Schmidt twice: a v parallel to the anchor collapses to a true
        # zero only after the second projection.
        w = v - anchor * (anchor * v).sum(dim=-1, keepdim=True)
        w = w - anchor * (anchor * w).sum(dim=-1, keepdim=True)
        return _unit_or(w, _perpendicular(anchor), 1e-5)

    top_gap_larger = ((lam1 - lam2) >= (lam2 - lam3))[..., None]
    v1_f = torch.where(top_gap_larger, v1, _orth(v1, v3))
    v3_f = torch.where(top_gap_larger, _orth(v3, v1), v3)
    v1, v3 = v1_f, v3_f
    v2 = _cross(v3, v1)
    vals = torch.stack([lam1, lam2, lam3], dim=-1)
    vecs = torch.stack([v1, v2, v3], dim=-1)  # columns
    return vals, vecs


def svd3x3(M: torch.Tensor):
    """Closed-form SVD of (..., 3, 3): ``(U, S (..., 3) descending, Vt)``.

    V and S come from :func:`eigh3x3` of MᵀM; U's first two columns are
    M·vᵢ/σᵢ and the third their cross product, its sign fixed so that
    M v₃ = σ₃ u₃.
    """
    vals, V = eigh3x3(M.transpose(-1, -2) @ M)
    S = torch.sqrt(vals.clamp_min(0.0))
    u1 = (M @ V[..., :, 0, None])[..., 0]
    u2 = (M @ V[..., :, 1, None])[..., 0]
    e0 = torch.zeros_like(u1)
    e0[..., 0] = 1.0
    e1 = torch.zeros_like(u2)
    e1[..., 1] = 1.0
    u1 = _unit_or(u1, e0, 1e-20)
    u2 = _unit_or(u2, e1, 1e-20)
    u2 = u2 - u1 * (u1 * u2).sum(dim=-1, keepdim=True)
    u2 = u2 - u1 * (u1 * u2).sum(dim=-1, keepdim=True)
    u2 = _unit_or(u2, _perpendicular(u1), 1e-5)
    u3 = _cross(u1, u2)
    mv3 = (M @ V[..., :, 2, None])[..., 0]
    sgn = torch.sign((u3 * mv3).sum(dim=-1, keepdim=True))
    u3 = u3 * torch.where(sgn == 0.0, torch.ones_like(sgn), sgn)
    U = torch.stack([u1, u2, u3], dim=-1)
    return U, S, V.transpose(-1, -2)


def _gauss_jordan_inverse_with_pivots(S: torch.Tensor):
    """Unrolled no-pivot Gauss-Jordan inverse of (..., n, n) SPD matrices,
    also returning the minimum elimination pivot (non-positive ⇒ roundoff
    left the system indefinite and the inverse is untrustworthy)."""
    n = S.shape[-1]
    eye = _eye(n, S).expand(S.shape)
    aug = torch.cat([S, eye], dim=-1)  # (..., n, 2n)
    min_pivot = torch.full(S.shape[:-2], math.inf, dtype=S.dtype, device=S.device)
    for k in range(n):
        pivot = aug[..., k, k : k + 1]  # (..., 1)
        min_pivot = torch.minimum(min_pivot, pivot[..., 0])
        row_k = aug[..., k, :] / pivot  # (..., 2n)
        factor = aug[..., :, k].clone()  # (..., n)
        factor[..., k] = 0.0
        aug = aug - factor[..., :, None] * row_k[..., None, :]
        aug = torch.cat([aug[..., :k, :], row_k[..., None, :], aug[..., k + 1 :, :]], dim=-2)
    return aug[..., :, n:], min_pivot


def _invert(M: torch.Tensor):
    if M.shape[-1] == 3:
        # Non-positive determinant ⇔ roundoff-indefinite input.
        return inv3x3(M), det3x3(M)
    return _gauss_jordan_inverse_with_pivots(M)


def smallest_eigvec_psd(
    S: torch.Tensor, iterations: int = 10, rescue: bool = True, pinned: bool = False
) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a PSD matrix (batched).

    Inverse iteration with an explicit inverse of S + ridge, the ridge
    1e-7·tr(S): above the f32 roundoff that can leave AᵀA slightly
    indefinite, below the informative spectral gap. ``rescue`` re-inverts
    with a 100x ridge where the first inverse is non-finite, exceeds the
    bound the ridge implies, or had a non-positive pivot. ``pinned`` sums
    the trace and the iteration's matvecs and norms with :func:`tree_sum`
    (the reference always does), so each matrix gets the same bits in any
    batch.
    """
    n = S.shape[-1]
    rsum = tree_sum if pinned else (lambda x, dim: x.sum(dim=dim))
    trace = rsum(torch.diagonal(S, dim1=-2, dim2=-1), -1)
    eye = _eye(n, S)
    ridge = (1e-7 * trace + 1e-12)[..., None, None] * eye
    S_inv, pivot_sig = _invert(S + ridge)
    if rescue:
        bound = 10.0 / (1e-7 * trace + 1e-12)[..., None, None]
        peak = S_inv.abs().amax(dim=(-2, -1), keepdim=True)
        bad = ~torch.isfinite(peak) | (peak > bound) | (pivot_sig <= 0)[..., None, None]
        S_inv = torch.where(bad, _invert(S + 100.0 * ridge)[0], S_inv)

    x = torch.linspace(1.0, 1.3, n, dtype=S.dtype, device=S.device).expand(*S.shape[:-2], n)
    for _ in range(iterations):
        x = rsum(S_inv * x[..., None, :], -1)
        norm = torch.sqrt(rsum(x * x, -1))[..., None]
        x = x / norm.clamp_min(1e-30)
    return x
