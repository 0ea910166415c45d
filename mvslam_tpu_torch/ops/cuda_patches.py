"""Kernel K2: 32x32 patch extraction around keypoints.

Replaces ``mvslam_tpu/ops/pallas_patches.py::extract_patches_pallas``
(core ``_extract_batched``, custom-vmap rules ``_extract_vmappable`` and
``_extract_vmappable_narrow``). The CUDA source is
``csrc/extract_patches.cu``; :func:`extract_patches_plain` is the same
function as a plain PyTorch index gather, which CPU tensors take and
against which the kernel is checked on the card.
"""

from __future__ import annotations

import torch

from mvslam_tpu_torch.core import cuda_build

PATCH_RADIUS = 15
PATCH_DIM = 32
PATCH_PIXELS = PATCH_DIM * PATCH_DIM


def _patch_starts(xy: torch.Tensor, h: int, w: int):
    """Clamped (x, y) starts: ``clip(round(xy) - 15, 0, dim - 32)``, with
    round-half-to-even like ``jnp.round``."""
    xi = (torch.round(xy[..., 0]).to(torch.int64) - PATCH_RADIUS).clamp(0, w - PATCH_DIM)
    yi = (torch.round(xy[..., 1]).to(torch.int64) - PATCH_RADIUS).clamp(0, h - PATCH_DIM)
    return xi, yi


def extract_patches_plain(image: torch.Tensor, xy: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """(B, H, W) image, (B, N, 2) xy → (B, N, 1024) flattened 32x32 tiles."""
    b, h, w = image.shape
    xi, yi = _patch_starts(xy, h, w)
    offs = torch.arange(PATCH_DIM, device=image.device)
    rows = yi[..., None, None] + offs[:, None]  # (B, N, 32, 1)
    cols = xi[..., None, None] + offs[None, :]  # (B, N, 1, 32)
    lin = (rows * w + cols).reshape(b, -1)
    patches = torch.gather(image.reshape(b, h * w), 1, lin).reshape(b, xy.shape[1], PATCH_PIXELS)
    return patches if out_dtype is None else patches.to(out_dtype)


def extract_patches(image: torch.Tensor, xy: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """(B, H, W) float32 image, (B, N, 2) float32 xy → (B, N, 1024) tiles in
    ``out_dtype`` (float32 when None, or bfloat16).

    CPU tensors take :func:`extract_patches_plain`; CUDA tensors launch
    the kernel on the current stream.
    """
    if image.device.type == "cpu":
        return extract_patches_plain(image, xy, out_dtype)
    if not image.is_cuda or xy.device != image.device:
        raise ValueError(f"extract_patches: image on {image.device}, xy on {xy.device}")
    if image.ndim != 3 or xy.ndim != 3 or xy.shape[0] != image.shape[0] or xy.shape[2] != 2:
        raise ValueError(
            f"extract_patches: expected image (B, H, W) and xy (B, N, 2), got "
            f"{tuple(image.shape)} and {tuple(xy.shape)}"
        )
    if image.dtype != torch.float32 or xy.dtype != torch.float32:
        raise ValueError(f"extract_patches: needs float32 image and xy, got {image.dtype}, {xy.dtype}")
    out_dtype = out_dtype or torch.float32
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"extract_patches: out_dtype must be float32 or bfloat16, got {out_dtype}")
    b, h, w = image.shape
    n = xy.shape[1]
    if h < PATCH_DIM or w < PATCH_DIM:
        raise ValueError(f"extract_patches: image {h}x{w} is smaller than a {PATCH_DIM}px tile")
    image = image.contiguous()
    xy = xy.contiguous()
    out = torch.empty((b, n, PATCH_PIXELS), dtype=out_dtype, device=image.device)
    if b * n == 0:
        return out
    name = "extract_patches_f32" if out_dtype == torch.float32 else "extract_patches_bf16"
    lib = cuda_build.load()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(image.data_ptr(), xy.data_ptr(), out.data_ptr(), b, h, w, n, stream)
    cuda_build.check(err, name)
    extract_patches.launches += 1
    return out


extract_patches.launches = 0  # kernel launches (plain-version calls do not count)
