"""Camera intrinsics estimation utilities.

Port of ``mvslam_tpu/frontend/intrinsics.py``: vanishing-point focal
estimation from matched line pairs, the FOV-based ``make_K_from_fov`` and
the ``fx fy cx cy`` file parser (both re-exported from
``geometry.projection``).

The vanishing-point method: two families of parallel scene lines project
to image lines meeting at vanishing points v1, v2; for orthogonal
families, (v1 − c)·(v2 − c) + f² = 0 with principal point c — solving for
f. Line intersections and each family's least-squares vanishing point are
float32 tensor ops; the focal solve is float64 numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from mvslam_tpu_torch.geometry.linalg import smallest_eigvec_psd
from mvslam_tpu_torch.geometry.projection import load_K_from_file, make_K, make_K_from_fov

__all__ = [
    "make_K",
    "make_K_from_fov",
    "load_K_from_file",
    "line_through_points",
    "intersect_lines",
    "estimate_focal_from_vanishing_points",
    "estimate_focal_from_line_pairs",
]


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def line_through_points(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Homogeneous line(s) through point pairs: l = p1 × p2 (batched)."""
    return torch.linalg.cross(_homogeneous(p1), _homogeneous(p2), dim=-1)


def intersect_lines(l1: torch.Tensor, l2: torch.Tensor) -> torch.Tensor:
    """Intersection point(s) of homogeneous lines: x = l1 × l2, dehomogenised."""
    x = torch.linalg.cross(l1, l2, dim=-1)
    w = x[..., 2:3]
    w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
    return x[..., :2] / w


def estimate_focal_from_vanishing_points(
    v1: np.ndarray, v2: np.ndarray, principal_point: np.ndarray
) -> Optional[float]:
    """f from two orthogonal vanishing points: f² = −(v1−c)·(v2−c).

    Returns None when the configuration is degenerate (f² ≤ 0).
    """
    c = np.asarray(principal_point, dtype=np.float64)
    d1 = np.asarray(v1, dtype=np.float64) - c
    d2 = np.asarray(v2, dtype=np.float64) - c
    f_sq = -float(d1 @ d2)
    if f_sq <= 0:
        return None
    return float(np.sqrt(f_sq))


def estimate_focal_from_line_pairs(
    family_a: Sequence[Tuple[np.ndarray, np.ndarray]],
    family_b: Sequence[Tuple[np.ndarray, np.ndarray]],
    principal_point: np.ndarray,
) -> Optional[float]:
    """Focal from two families of (assumed orthogonal) parallel scene lines.

    Each family is a sequence of image segments ((x1, y1), (x2, y2)); the
    family's vanishing point is the least-squares intersection of its
    lines (smallest eigenvector of Σ l lᵀ, scale-normalised).
    """

    def vanishing_point(family) -> Optional[np.ndarray]:
        if len(family) < 2:
            return None
        p1 = torch.tensor(np.asarray([seg[0] for seg in family], dtype=np.float32))
        p2 = torch.tensor(np.asarray([seg[1] for seg in family], dtype=np.float32))
        lines = line_through_points(p1, p2)
        norms = torch.linalg.vector_norm(lines[..., :2], dim=-1, keepdim=True)
        lines = lines / torch.where(norms < 1e-12, torch.full_like(norms, 1e-12), norms)
        # Least-squares point minimising Σ (lᵀ x)²: smallest eigvec of Σ l lᵀ.
        x = smallest_eigvec_psd(lines.T @ lines)
        if abs(float(x[2])) < 1e-9:
            return None
        return (x[:2] / x[2]).numpy().astype(np.float64)

    va = vanishing_point(family_a)
    vb = vanishing_point(family_b)
    if va is None or vb is None:
        return None
    return estimate_focal_from_vanishing_points(va, vb, principal_point)
