"""FAST-9/16 corner detection with static output shapes.

Port of ``mvslam_tpu/ops/fast.py``: a dense per-pixel corner response,
3x3 non-maximum suppression, a border mask, then a static top-K selection
(optionally per grid cell) into a padded ``(..., N, 2)`` keypoint array
with a validity mask. On CUDA tensors the score, NMS and border mask run
as one hand-written kernel (``ops.cuda_fast.fast_detect``).

Every top-K here is a *stable* descending sort: ``jax.lax.top_k`` puts the
lower index first among equal values, and integer FAST scores tie often.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# FAST circle of radius 3: 16 (dy, dx) offsets, clockwise from 12 o'clock.
_CIRCLE = np.asarray(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3),
        (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)


@dataclass(frozen=True)
class FastConfig:
    threshold: float = 20.0
    nms_radius: int = 1  # 3x3 NMS window
    border_margin: int = 19  # keep clear of the 31px BRIEF patch + blur
    grid_cells: int = 0  # 0 = global top-K; else GxG cell-balanced selection
    # Fused detect kernel (score + NMS + border in one pass). None = auto
    # (the CUDA kernel for CUDA tensors, the plain formulation for CPU
    # tensors); True forces the kernel's wrapper (its plain version on the
    # CPU), False forces the plain wrap-around formulation.
    use_pallas: bool | None = None
    # Quadratic subpixel peak refinement on the raw score map.
    subpixel: bool = True
    # Kept for config parity with the reference; its approx_max_k
    # selection exists only on the TPU, so only None/False are accepted.
    approx_select: bool | None = None


def _taps(img: torch.Tensor, wrap: bool):
    """The 16 circle taps of every pixel: tap i at (y, x) is
    img[y + dy_i, x + dx_i], wrapping circularly or reading zeros outside."""
    if wrap:
        return [torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(-2, -1)) for dy, dx in _CIRCLE]
    h, w = img.shape[-2:]
    padded = F.pad(img, (3, 3, 3, 3))
    return [padded[..., 3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] for dy, dx in _CIRCLE]


def _has_arc(bits: torch.Tensor) -> torch.Tensor:
    """Circular run of 9 set bits in a 16-bit mask (int32 tensor): the
    log-depth AND-shift halving of the reference on the mask doubled to 32
    bits, so bit i of ``m9`` means bits i..i+8 are all set."""
    d = bits | (bits << 16)
    m2 = d & (d >> 1)
    m4 = m2 & (m2 >> 2)
    m8 = m4 & (m4 >> 4)
    m9 = m8 & (d >> 8)
    return (m9 & 0xFFFF) != 0


def fast_score_map(image: torch.Tensor, threshold: float, wrap: bool = True) -> torch.Tensor:
    """Dense FAST-9 corner response over (..., H, W); 0 where the arc test
    fails, else the sum of ``|tap - centre| - t`` over the taps of the
    winning polarity.

    8-bit integer images with an integral threshold are scored in int32
    (exact, and equal to the float scores). ``wrap`` selects the
    reference's circular taps (True) or zero taps outside the image
    (False, the CUDA kernel's semantics).
    """
    if image.dtype in (torch.uint8, torch.int8) and float(threshold).is_integer():
        t = int(threshold)
        img = image.to(torch.int32)
    else:
        t = float(threshold)
        img = image.to(torch.float32)
    zero = torch.zeros_like(img)
    bright, dark = zero, zero
    bright_bits = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    dark_bits = torch.zeros_like(bright_bits)
    # Sequential accumulation in circle order (the kernel's order).
    for i, tap in enumerate(_taps(img, wrap)):
        diff = tap - img
        b = diff > t
        d = diff < -t
        excess = diff.abs() - t
        bright = bright + torch.where(b, excess, zero)
        dark = dark + torch.where(d, excess, zero)
        bright_bits = bright_bits | (b.to(torch.int32) << i)
        dark_bits = dark_bits | (d.to(torch.int32) << i)
    is_bright = _has_arc(bright_bits)
    is_dark = _has_arc(dark_bits)
    fzero = torch.zeros((), dtype=torch.float32, device=img.device)
    score = torch.maximum(
        torch.where(is_bright, bright.to(torch.float32), fzero),
        torch.where(is_dark, dark.to(torch.float32), fzero),
    )
    return torch.where(is_bright | is_dark, score, fzero)


def _nms(score: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep a score where it equals the max of its (2r+1)² window (>=,
    so plateaus survive); outside the image counts as -inf."""
    h, w = score.shape[-2:]
    window = 2 * radius + 1
    pooled = F.max_pool2d(
        score.reshape(-1, 1, h, w), window, stride=1, padding=radius
    ).reshape(score.shape)
    return torch.where(score >= pooled, score, torch.zeros((), dtype=score.dtype, device=score.device))


def _mask_border(score: torch.Tensor, margin: int) -> torch.Tensor:
    h, w = score.shape[-2:]
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    keep = (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
    return torch.where(keep, score, torch.zeros((), dtype=score.dtype, device=score.device))


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: descending, lower index first
    among equal values."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _grid_topk(
    score: torch.Tensor,
    num_keypoints: int,
    cells: int,
    approx_select: bool | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell-balanced candidate selection: top-(2k/cell²) per cell, then a
    global top-K over the union. Returns (scores, linear pixel indices)."""
    if approx_select:
        raise ValueError("approx_select (approx_max_k) is TPU-only; the port selects exactly")
    lead = score.shape[:-2]
    h, w = score.shape[-2:]
    ch = -(-h // cells)
    cw = -(-w // cells)
    padded = F.pad(score, (0, cw * cells - w, 0, ch * cells - h))
    tiles = (
        padded.reshape(*lead, cells, ch, cells, cw)
        .transpose(-3, -2)
        .reshape(*lead, cells * cells, ch * cw)
    )
    per_cell = max(1, -(-num_keypoints // (cells * cells)) * 2)
    per_cell = min(per_cell, ch * cw)
    cell_scores, cell_idx = topk_stable(tiles, per_cell)  # (..., C², per_cell)
    cell_ids = torch.arange(cells * cells, device=score.device)[:, None]
    ys = (cell_ids // cells) * ch + cell_idx // cw
    xs = (cell_ids % cells) * cw + cell_idx % cw
    flat_scores = cell_scores.reshape(*lead, -1)
    flat_lin = (ys * w + xs).reshape(*lead, -1)
    top_scores, pick = topk_stable(flat_scores, min(num_keypoints, flat_scores.shape[-1]))
    return top_scores, torch.gather(flat_lin, -1, pick)


def _subpixel_offset(minus, centre, plus):
    denom = minus - 2.0 * centre + plus
    off = torch.where(denom.abs() > 1e-6, 0.5 * (minus - plus) / denom, torch.zeros_like(denom))
    return off.clamp(-0.5, 0.5)


def detect_keypoints(
    image: torch.Tensor,
    num_keypoints: int = 1024,
    config: FastConfig = FastConfig(),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Detect FAST corners in (..., H, W) images with static output shapes.

    Returns ``(xy, scores, valid)``: xy (..., N, 2) float32 as (x, y)
    pixel coordinates, scores (..., N), valid (..., N) bool. Invalid slots
    hold (0, 0) with score 0.
    """
    use_kernel = config.use_pallas if config.use_pallas is not None else image.is_cuda
    lead = image.shape[:-2]
    h, w = image.shape[-2:]
    # margin >= 4: the kernel's zero taps only match the circular roll once
    # the border mask kills every pixel whose taps or NMS pool reach the seam.
    if use_kernel and config.nms_radius == 1 and config.border_margin >= 4:
        from mvslam_tpu_torch.ops.cuda_fast import fast_detect

        score, raw = fast_detect(
            image.reshape(-1, h, w), float(config.threshold), margin=config.border_margin
        )
        score, raw = score.reshape(*lead, h, w), raw.reshape(*lead, h, w)
    else:
        raw = fast_score_map(image, config.threshold)
        score = _mask_border(_nms(raw, config.nms_radius), config.border_margin)
    if config.grid_cells > 1:
        top_scores, lin = _grid_topk(score, num_keypoints, config.grid_cells, config.approx_select)
        if top_scores.shape[-1] < num_keypoints:
            pad = num_keypoints - top_scores.shape[-1]
            top_scores = F.pad(top_scores, (0, pad))
            lin = F.pad(lin, (0, pad))
    else:
        top_scores, lin = topk_stable(score.reshape(*lead, h * w), num_keypoints)
    valid = top_scores > 0.0
    xy = torch.stack([(lin % w).to(torch.float32), (lin // w).to(torch.float32)], dim=-1)
    if config.subpixel:
        # 3-point parabola peak on the RAW (pre-NMS) response. The border
        # margin keeps every selected peak's 4-neighbourhood in bounds; lin
        # is clamped so invalid (padded) slots stay in range.
        raw_flat = raw.reshape(*lead, h * w).to(torch.float32)
        lin_c = lin.clamp(w + 1, h * w - w - 2)

        def at(offset):
            return torch.gather(raw_flat, -1, lin_c + offset)

        centre = at(0)
        dx = _subpixel_offset(at(-1), centre, at(1))
        dy = _subpixel_offset(at(-w), centre, at(w))
        xy = xy + torch.stack([dx, dy], dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=image.device)
    xy = torch.where(valid[..., None], xy, zero)
    return xy, torch.where(valid, top_scores, zero), valid
