"""Image preprocessing: grayscale, separable Gaussian blur, 2x downsample.

Port of ``mvslam_tpu/ops/image.py``. Float32 images in [0, 255], batched
over any leading axes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def rgb_to_gray(frame: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) → (..., H, W) float32 with BT.601 luma weights;
    (..., H, W) input is only cast to float32."""
    frame = frame.to(torch.float32)
    if frame.ndim >= 3 and frame.shape[-1] == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=frame.device)
        return frame @ w
    return frame


def _gaussian_kernel(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(image: torch.Tensor, sigma: float = 1.0, radius: int = 2) -> torch.Tensor:
    """Separable Gaussian blur over the trailing (H, W) axes.

    Shifted weighted sums that wrap circularly (``torch.roll``), as the
    reference does; only the outer ``radius`` pixels differ from an
    edge-replicating blur, all inside the detector's border margin.
    """
    kernel = [float(v) for v in _gaussian_kernel(sigma, radius)]
    img = image.to(torch.float32)

    def sweep(x, dim):
        acc = kernel[radius] * x
        for k in range(1, radius + 1):
            acc = acc + kernel[radius + k] * torch.roll(x, -k, dims=dim)
            acc = acc + kernel[radius - k] * torch.roll(x, k, dims=dim)
        return acc

    return sweep(sweep(img, -2), -1)


def downsample2(image: torch.Tensor) -> torch.Tensor:
    """2x area downsample of the trailing (H, W) axes."""
    h = (image.shape[-2] // 2) * 2
    w = (image.shape[-1] // 2) * 2
    img = image[..., :h, :w]
    return 0.25 * (
        img[..., 0::2, 0::2] + img[..., 1::2, 0::2] + img[..., 0::2, 1::2] + img[..., 1::2, 1::2]
    )


def build_pyramid(image: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """A plain 2x pyramid: a list of ``num_levels`` images, level 0 at full
    resolution, each next level :func:`downsample2` of the last."""
    levels = [image]
    for _ in range(num_levels - 1):
        levels.append(downsample2(levels[-1]))
    return levels


def scale_for_level(level: int) -> float:
    """Pixel scale of pyramid ``level`` relative to level 0."""
    return float(2**level)


def pad_to_multiple(image: torch.Tensor, multiple: int = 128) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Zero-pad the trailing (H, W) axes up to a multiple of ``multiple``;
    returns (padded, original (H, W))."""
    h, w = image.shape[-2], image.shape[-1]
    ph, pw = (-h) % multiple, (-w) % multiple
    if ph or pw:
        image = F.pad(image, (0, pw, 0, ph))
    return image, (h, w)
