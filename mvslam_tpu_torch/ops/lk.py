"""Pyramidal Lucas-Kanade optical flow, all points through fixed
Gauss-Newton iterations per level.

Port of ``mvslam_tpu/ops/lk.py``. Every iteration needs an image window at
a sub-pixel location: the 32x32 tile at the window's integer corner comes
from kernel K2 (``ops.cuda_patches.extract_patches``, float32 output, one
launch per iteration for all points), and the fractional part is applied
as a 4-tap bilinear blend of shifted views of the tile. The 2x2 normal
systems of all points solve in closed form. The reference's ``lax.scan``
over iterations is a Python loop: per level, one template launch, one per
iteration and one for the final residual.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from mvslam_tpu_torch.ops import cuda_patches
from mvslam_tpu_torch.ops.cuda_patches import PATCH_DIM, PATCH_RADIUS
from mvslam_tpu_torch.ops.image import downsample2, gaussian_blur

_WIN = 21  # LK window (cv2 default 21x21)
_TILE = PATCH_DIM


@dataclass(frozen=True)
class LKConfig:
    """Same fields and defaults as the reference's config."""

    num_levels: int = 3
    iterations: int = 8
    min_determinant: float = 1e-4
    max_residual: float = 25.0  # mean |dI| gate for a converged track
    # KLT assumes locally linear intensity; pre-smoothing widens the
    # convergence basin on high-frequency texture. 0 disables.
    blur_sigma: float = 1.5
    window: int = _WIN  # fixed; part of the config for reporting


def _bilinear_windows(image: torch.Tensor, pts: torch.Tensor, pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, _WIN+2·pad, _WIN+2·pad) windows of ``image`` (H, W) at sub-pixel
    centres ``pts`` (N, 2), and the in-bounds mask (N,).

    The window's integer corner is floor(p) - (_WIN//2 + pad), so the
    central _WIN×_WIN block stays centred on p for any ``pad``.
    """
    h, w = image.shape
    half = _WIN // 2 + pad
    fl = torch.floor(pts)
    fx = pts[:, 0] - fl[:, 0]
    fy = pts[:, 1] - fl[:, 1]
    # K2 starts its tile at round(x') - PATCH_RADIUS; x' = floor(x) +
    # (PATCH_RADIUS - half) is an integer, so the corner is floor(x) - half.
    xy = fl + float(PATCH_RADIUS - half)
    tiles = cuda_patches.extract_patches(image[None], xy[None], out_dtype=torch.float32)
    tiles = tiles.reshape(-1, _TILE, _TILE)

    size = _WIN + 2 * pad
    t00 = tiles[:, :size, :size]
    t01 = tiles[:, :size, 1 : size + 1]
    t10 = tiles[:, 1 : size + 1, :size]
    t11 = tiles[:, 1 : size + 1, 1 : size + 1]
    wx = fx[:, None, None]
    wy = fy[:, None, None]
    win = (
        (1.0 - wy) * (1.0 - wx) * t00
        + (1.0 - wy) * wx * t01
        + wy * (1.0 - wx) * t10
        + wy * wx * t11
    )
    # K2 clamps the FULL 32 px tile into the image, so the mask requires
    # the whole tile in bounds: a looser check on the sampled square would
    # accept silently shifted windows near the right and bottom borders.
    x0 = fl[:, 0] - half
    y0 = fl[:, 1] - half
    ok = (x0 >= 0) & (y0 >= 0) & (x0 + _TILE <= w) & (y0 + _TILE <= h)
    return win, ok


def _lk_level(prev_img, next_img, pts_prev, guess, config: LKConfig):
    """One pyramid level: ``config.iterations`` GN steps for all points."""
    # Template window and central-difference gradients at the PREV
    # location, from a window one pixel wider on each side.
    tw, ok_prev = _bilinear_windows(prev_img, pts_prev, pad=1)
    template = tw[:, 1:-1, 1:-1]  # (N, 21, 21)
    ix = 0.5 * (tw[:, 1:-1, 2:] - tw[:, 1:-1, :-2])
    iy = 0.5 * (tw[:, 2:, 1:-1] - tw[:, :-2, 1:-1])
    gxx = (ix * ix).sum(dim=(1, 2))
    gxy = (ix * iy).sum(dim=(1, 2))
    gyy = (iy * iy).sum(dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    solvable = det > config.min_determinant
    det_safe = torch.where(solvable, det, torch.ones_like(det))

    d = guess
    for _ in range(config.iterations):
        win, ok = _bilinear_windows(next_img, pts_prev + d, pad=0)
        di = win - template
        bx = (di * ix).sum(dim=(1, 2))
        by = (di * iy).sum(dim=(1, 2))
        # 2x2 solve: G @ step = -b
        sx = -(gyy * bx - gxy * by) / det_safe
        sy = -(-gxy * bx + gxx * by) / det_safe
        step = torch.stack([sx, sy], dim=-1)
        # ok_prev gates the step too: a border-clamped template is shifted,
        # and refining against it would drag d toward the shifted content.
        step = torch.where((solvable & ok & ok_prev)[:, None], step, torch.zeros_like(step))
        d = d + step
    win, ok = _bilinear_windows(next_img, pts_prev + d, pad=0)
    residual = (win - template).abs().mean(dim=(1, 2))
    valid = solvable & ok & ok_prev & (residual <= config.max_residual)
    return d, residual, valid


def lk_track(
    prev_img: torch.Tensor,
    next_img: torch.Tensor,
    pts: torch.Tensor,
    mask: torch.Tensor,
    config: LKConfig = LKConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Track ``pts`` (N, 2) from ``prev_img`` to ``next_img`` (H, W).

    Returns ``(next_pts (N, 2), residuals (N,), valid (N,))`` — the
    fixed-shape analog of cv2.calcOpticalFlowPyrLK's (nextPts, status,
    err). Invalid input slots (``mask`` False) stay invalid.
    """
    prev_img = prev_img.to(torch.float32)
    next_img = next_img.to(torch.float32)
    if config.blur_sigma > 0:
        prev_img = gaussian_blur(prev_img, sigma=config.blur_sigma, radius=2)
        next_img = gaussian_blur(next_img, sigma=config.blur_sigma, radius=2)

    # Pyramid, stopping before a level too small for two tiles.
    prevs, nexts = [prev_img], [next_img]
    for _ in range(config.num_levels - 1):
        if min(prevs[-1].shape) < 2 * _TILE:
            break
        prevs.append(downsample2(prevs[-1]))
        nexts.append(downsample2(nexts[-1]))

    pts = pts.to(torch.float32)
    d = torch.zeros_like(pts)
    residual = torch.zeros(pts.shape[0], dtype=torch.float32, device=pts.device)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    for level in reversed(range(len(prevs))):
        # Coarse levels only refine the displacement guess; validity comes
        # from the finest level alone.
        d, residual, valid = _lk_level(prevs[level], nexts[level], pts / float(2**level), d, config)
        if level > 0:
            d = d * 2.0
    next_pts = pts + d
    h, w = next_img.shape
    inside = (
        (next_pts[:, 0] >= 0)
        & (next_pts[:, 0] <= w - 1)
        & (next_pts[:, 1] >= 0)
        & (next_pts[:, 1] <= h - 1)
    )
    return next_pts, residual, valid & inside & mask.to(torch.bool)
