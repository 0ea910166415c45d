"""Pixel normalisation and Hartley conditioning.

Port of the tracking step's part of ``mvslam_tpu/geometry/projection.py``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def normalize_pixels(pts: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel → normalised camera coordinates: K⁻¹ [u v 1]."""
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    x = (pts[..., 0] - cx) / fx
    y = (pts[..., 1] - cy) / fy
    return torch.stack([x, y], dim=-1)


def hartley_normalization(
    pts: torch.Tensor, weights: torch.Tensor | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley point normalisation: zero (weighted) mean, mean distance √2.

    pts (..., N, 2), optional weights (..., N). Returns (normalised
    points, (..., 3, 3) conditioning transform T) with ``x_norm = T @ x``.
    """
    if weights is None:
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
