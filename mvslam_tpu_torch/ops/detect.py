"""Fused (optionally multi-scale) detect + describe.

Port of ``mvslam_tpu/ops/detect.py``. Each pyramid level gets an equal
share of the keypoint budget; keypoint coordinates map back to level-0
pixels (2x area downsampling ⇒ x₀ = 2ˡ·x + (2ˡ−1)/2). Batched over any
leading axes of the (..., H, W) image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mvslam_tpu_torch.ops.brief import BriefConfig, describe_keypoints
from mvslam_tpu_torch.ops.fast import FastConfig, detect_keypoints
from mvslam_tpu_torch.ops.image import downsample2, gaussian_blur


def detect_and_describe(
    gray: torch.Tensor,
    num_features: int,
    fast_config: FastConfig,
    brief_config: BriefConfig,
    num_levels: int = 1,
    score_image: torch.Tensor = None,
):
    """(..., H, W) grayscale → (xy, scores, descriptors, angles, valid).

    ``score_image`` (the raw 8-bit frame, when available) feeds the FAST
    score map's exact integer path at level 0; description and the pyramid
    always use the float grayscale.
    """
    num_levels = max(1, int(num_levels))
    per_level = max(1, num_features // num_levels)
    lead = gray.shape[:-2]
    parts = []
    img = gray
    for level in range(num_levels):
        h, w = img.shape[-2], img.shape[-1]
        if h < 2 * fast_config.border_margin + 8 or w < 2 * fast_config.border_margin + 8:
            break
        budget = per_level if level < num_levels - 1 else num_features - per_level * (num_levels - 1)
        budget = max(1, budget)
        src = score_image if (level == 0 and score_image is not None) else img
        xy, scores, valid = detect_keypoints(src, num_keypoints=budget, config=fast_config)
        blurred = gaussian_blur(img, sigma=brief_config.blur_sigma, radius=brief_config.blur_radius)
        desc, angles = describe_keypoints(blurred, xy, valid, config=brief_config)
        scale = float(2**level)
        xy0 = torch.where(valid[..., None], xy * scale + (scale - 1.0) / 2.0, torch.zeros_like(xy))
        parts.append((xy0, scores, desc, angles, valid))
        if level < num_levels - 1:
            img = downsample2(img)

    device = gray.device
    if not parts:
        # Image smaller than the FAST border at every level: an all-invalid
        # padded feature set keeps the static-shape contract.
        return (
            torch.zeros((*lead, num_features, 2), dtype=torch.float32, device=device),
            torch.zeros((*lead, num_features), dtype=torch.float32, device=device),
            torch.zeros((*lead, num_features, 8), dtype=torch.int32, device=device),
            torch.zeros((*lead, num_features), dtype=torch.float32, device=device),
            torch.zeros((*lead, num_features), dtype=torch.bool, device=device),
        )
    xy, scores, desc, angles, valid = (
        torch.cat([p[i] for p in parts], dim=len(lead)) for i in range(5)
    )
    total = xy.shape[-2]
    if total < num_features:
        pad = num_features - total
        xy = F.pad(xy, (0, 0, 0, pad))
        scores = F.pad(scores, (0, pad))
        desc = F.pad(desc, (0, 0, 0, pad))
        angles = F.pad(angles, (0, pad))
        valid = F.pad(valid, (0, pad))
    elif total > num_features:
        xy, scores, desc, angles, valid = (
            xy[..., :num_features, :],
            scores[..., :num_features],
            desc[..., :num_features, :],
            angles[..., :num_features],
            valid[..., :num_features],
        )
    return xy, scores, desc, angles, valid
