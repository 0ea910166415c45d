"""Camera models, projection, batched DLT triangulation, pixel
normalisation and Hartley conditioning.

Port of ``mvslam_tpu/geometry/projection.py``. Triangulation solves one 4x4
DLT system per correspondence by inverse iteration
(``linalg.smallest_eigvec_psd``), batched.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from mvslam_tpu_torch.geometry.linalg import smallest_eigvec_psd, tree_sum


def make_K(fx: float, fy: float, cx: float, cy: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """Assemble a 3x3 intrinsics matrix."""
    return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=dtype, device=device)


def make_K_from_fov(width: int, height: int, fov_deg: float = 60.0, dtype=torch.float32, device=None) -> torch.Tensor:
    """Intrinsics from a horizontal field of view."""
    f = 0.5 * width / np.tan(0.5 * np.deg2rad(fov_deg))
    return make_K(f, f, width * 0.5, height * 0.5, dtype=dtype, device=device)


def load_K_from_file(path: Path) -> np.ndarray:
    """Parse an ``fx fy cx cy`` intrinsics line."""
    text = Path(path).read_text().strip().split()
    if len(text) < 4:
        raise ValueError(f"{path}: expected 'fx fy cx cy', got {text!r}")
    fx, fy, cx, cy = (float(v) for v in text[:4])
    return np.asarray([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=np.float64)


def project_points(points_3d: torch.Tensor, K: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    """Project world points (..., N, 3) through world→camera poses T_cw
    (..., 4, 4) and pinhole K: pixel coordinates (..., N, 2)."""
    R = T_cw[..., :3, :3]
    t = T_cw[..., :3, 3]
    cam = points_3d @ R.transpose(-1, -2) + t[..., None, :]
    z = cam[..., 2:3]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    uv = cam[..., :2] / z
    u = uv[..., 0] * K[..., 0, 0, None] + K[..., 0, 2, None]
    v = uv[..., 1] * K[..., 1, 1, None] + K[..., 1, 2, None]
    return torch.stack([u, v], dim=-1)


def camera_depths(points_3d: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    """Depth (z in the camera frame) of world points under pose T_cw."""
    R = T_cw[..., :3, :3]
    t = T_cw[..., :3, 3]
    return (points_3d @ R.transpose(-1, -2) + t[..., None, :])[..., 2]


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """Batched two-view DLT triangulation: (3, 4) projections, (N, 2)
    points in each view → (N, 3) euclidean points."""

    def rows(P, pts):
        u = pts[:, 0:1]
        v = pts[:, 1:2]
        return torch.stack([u * P[2:3, :] - P[0:1, :], v * P[2:3, :] - P[1:2, :]], dim=1)  # (N, 2, 4)

    A = torch.cat([rows(P1, pts1), rows(P2, pts2)], dim=1)  # (N, 4, 4)
    X = smallest_eigvec_psd(A.transpose(-1, -2) @ A)
    w = X[..., 3]
    return X[..., :3] / torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)[..., None]


def triangulate_pair(
    K: torch.Tensor, R: torch.Tensor, t: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor
) -> torch.Tensor:
    """Triangulate with camera 1 at identity and camera 2 at [R|t]."""
    dtype, device = pts1.dtype, pts1.device
    K = K.to(dtype)
    P1 = K @ torch.cat([torch.eye(3, dtype=dtype, device=device), torch.zeros((3, 1), dtype=dtype, device=device)], dim=1)
    P2 = K @ torch.cat([R.to(dtype), t.to(dtype).reshape(3, 1)], dim=1)
    return triangulate_dlt(P1, P2, pts1, pts2)


def normalize_pixels(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel → normalised camera coordinates: K⁻¹ [u v 1]."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    x = (pts[..., 0] - cx) / fx
    y = (pts[..., 1] - cy) / fy
    return torch.stack([x, y], dim=-1)


def hartley_normalization(
    pts: torch.Tensor, weights: torch.Tensor | None = None, pinned: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley point normalisation: zero (weighted) mean, mean distance √2.

    pts (..., N, 2), optional weights (..., N). Returns (normalised
    points, (..., 3, 3) conditioning transform T) with ``x_norm = T @ x``.
    ``pinned`` accumulates every statistic with ``tree_sum`` and written-out
    adds (elementwise only), so a point set gets the same bits in any batch.
    """
    if pinned:

        def norm(c):
            return torch.sqrt(c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1])

        if weights is None:
            n = pts.shape[-2]
            mean = tree_sum(pts, -2)[..., None, :] / n
            centered = pts - mean
            mean_dist = tree_sum(norm(centered), -1) / n
        else:
            wsum = tree_sum(weights, -1)[..., None]
            wsum = torch.where(wsum < 1e-12, torch.full_like(wsum, 1e-12), wsum)
            mean = tree_sum(pts * weights[..., None], -2)[..., None, :] / wsum[..., None]
            centered = pts - mean
            mean_dist = tree_sum(norm(centered) * weights, -1) / wsum[..., 0]
    elif weights is None:
        mean = pts.mean(dim=-2, keepdim=True)
        centered = pts - mean
        mean_dist = torch.sqrt((centered * centered).sum(dim=-1)).mean(dim=-1)
    else:
        wsum = weights.sum(dim=-1)[..., None]
        wsum = torch.where(wsum < 1e-12, torch.full_like(wsum, 1e-12), wsum)
        mean = (pts * weights[..., None]).sum(dim=-2)[..., None, :] / wsum[..., None]
        centered = pts - mean
        dist = torch.sqrt((centered * centered).sum(dim=-1))
        mean_dist = (dist * weights).sum(dim=-1) / wsum[..., 0]
    safe = torch.where(mean_dist < 1e-12, torch.full_like(mean_dist, 1e-12), mean_dist)
    scale = math.sqrt(2.0) / safe
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack(
        [
            torch.stack([scale, zero, -scale * mean[..., 0, 0]], dim=-1),
            torch.stack([zero, scale, -scale * mean[..., 0, 1]], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    return centered * scale[..., None, None], T
