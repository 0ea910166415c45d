"""Oriented (steered) BRIEF descriptors.

Port of ``mvslam_tpu/ops/brief.py``: one 32x32 tile per keypoint (kernel
K2 on CUDA tensors), the intensity-centroid angle as a product with two
moment vectors, the angle quantised to 32 bins, and all 256 pair
comparisons of every bin as ONE bf16 product with a ±1 comparison bank;
each keypoint keeps its bin's 256 signs, packed into 8 32-bit words.

Descriptor words are carried as int32 (the bit pattern of the reference's
uint32 words): torch has no usable uint32 shifts on the CPU. Patches are
cast to bf16 at the same points as the reference, so angle bins and bits
agree with it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from mvslam_tpu_torch.ops import cuda_patches
from mvslam_tpu_torch.ops.cuda_patches import PATCH_DIM, PATCH_PIXELS, PATCH_RADIUS

PATCH_SIZE = 2 * PATCH_RADIUS + 1  # 31 (logical patch inside the 32x32 tile)
NUM_PAIRS = 256
NUM_ANGLE_BINS = 32
_PATTERN_SEED = 0x5EED
_MAX_OFFSET_NORM = 14.0  # rotations stay inside the 31x31 patch


def _make_pattern() -> np.ndarray:
    """(NUM_PAIRS, 2, 2) float: pairs of (dx, dy) offsets within the disk."""
    rng = np.random.default_rng(_PATTERN_SEED)
    sigma = PATCH_RADIUS / 5.0 * 2.0
    pts = rng.normal(0.0, sigma, size=(NUM_PAIRS, 2, 2))
    norms = np.linalg.norm(pts, axis=-1, keepdims=True)
    over = norms > _MAX_OFFSET_NORM
    return np.where(over, pts * (_MAX_OFFSET_NORM / np.maximum(norms, 1e-9)), pts)


def _make_moments() -> np.ndarray:
    """(1024, 2) m10/m01 weights over the radius-15 disk in the 32x32 tile
    (the dead row and column weigh zero)."""
    cy, cx = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
    circle = ((cx**2 + cy**2) <= PATCH_RADIUS**2).astype(np.float32)
    moments = np.zeros((PATCH_DIM, PATCH_DIM, 2), dtype=np.float32)
    moments[:PATCH_SIZE, :PATCH_SIZE, 0] = cx * circle
    moments[:PATCH_SIZE, :PATCH_SIZE, 1] = cy * circle
    return moments.reshape(PATCH_PIXELS, 2)


def _build_comparison_bank(pattern: np.ndarray) -> np.ndarray:
    """(1024, NUM_ANGLE_BINS * NUM_PAIRS) ±1 bank: column (b, j) computes
    I(p2_j rotated by angle_b) − I(p1_j rotated by angle_b)."""
    bank = np.zeros((PATCH_PIXELS, NUM_ANGLE_BINS, NUM_PAIRS), dtype=np.float32)
    for b in range(NUM_ANGLE_BINS):
        ang = 2.0 * np.pi * b / NUM_ANGLE_BINS
        c, s = np.cos(ang), np.sin(ang)
        rot = np.stack([c * pattern[..., 0] - s * pattern[..., 1],
                        s * pattern[..., 0] + c * pattern[..., 1]], axis=-1)
        ri = np.clip(np.round(rot), -PATCH_RADIUS, PATCH_RADIUS).astype(np.int64)
        for j in range(NUM_PAIRS):
            x1, y1 = ri[j, 0]
            x2, y2 = ri[j, 1]
            idx1 = (y1 + PATCH_RADIUS) * PATCH_DIM + (x1 + PATCH_RADIUS)
            idx2 = (y2 + PATCH_RADIUS) * PATCH_DIM + (x2 + PATCH_RADIUS)
            bank[idx2, b, j] += 1.0
            bank[idx1, b, j] -= 1.0
    return bank.reshape(PATCH_PIXELS, NUM_ANGLE_BINS * NUM_PAIRS)


_PATTERN = _make_pattern()
_MOMENTS = _make_moments()
_COMPARISON_BANK = _build_comparison_bank(_PATTERN)
_device_tables: dict = {}  # device -> (moments, bank) as bf16 tensors


def load_reference_tables(pattern: np.ndarray, moments: np.ndarray, bank: np.ndarray) -> None:
    """Install externally built tables (e.g. the reference package's numpy
    arrays), so both packages provably compute with identical tables."""
    global _PATTERN, _MOMENTS, _COMPARISON_BANK
    _PATTERN = np.asarray(pattern, dtype=np.float64)
    _MOMENTS = np.asarray(moments, dtype=np.float32).reshape(PATCH_PIXELS, 2)
    _COMPARISON_BANK = np.asarray(bank, dtype=np.float32).reshape(
        PATCH_PIXELS, NUM_ANGLE_BINS * NUM_PAIRS
    )
    _device_tables.clear()


def _tables(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(moments, bank) as bf16 tensors on ``device`` (both exact in bf16)."""
    device = torch.device(device)
    entry = _device_tables.get(device)
    if entry is None:
        entry = (
            torch.as_tensor(_MOMENTS, device=device).to(torch.bfloat16),
            torch.as_tensor(_COMPARISON_BANK, device=device).to(torch.bfloat16),
        )
        _device_tables[device] = entry
    return entry


@dataclass(frozen=True)
class BriefConfig:
    blur_sigma: float = 2.0
    blur_radius: int = 4


def extract_patches(image: torch.Tensor, xy: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """(..., N, 1024) flattened 32x32 tiles around rounded keypoint
    locations, starts clamped so the tile stays inside the image (the
    detector's border margin keeps real keypoints interior).

    Batched over any leading axes of (..., H, W) / (..., N, 2); kernel K2
    on CUDA tensors (``ops.cuda_patches``).
    """
    lead = image.shape[:-2]
    h, w = image.shape[-2:]
    n = xy.shape[-2]
    out = cuda_patches.extract_patches(image.reshape(-1, h, w), xy.reshape(-1, n, 2), out_dtype=out_dtype)
    return out.reshape(*lead, n, PATCH_PIXELS)


def orientations_from_patches(patches: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per patch: atan2(m01, m10), from bf16
    patches and the moment weights.

    The sums run in float64, where every product of a bf16 pixel and an
    integer weight and, for the blurred 8-bit frames of the tracker, every
    partial sum is exact: each moment is its exactly rounded float32 value
    whatever order the product sums in, so a frame gets the same angles in
    any batch (a float32 product sums in an order that its shape selects)."""
    moments, _ = _tables(patches.device)
    m = (patches.to(torch.bfloat16).to(torch.float64) @ moments.to(torch.float64)).to(torch.float32)
    angle = torch.atan2(m[..., 1], m[..., 0])
    return torch.where(valid, angle, torch.zeros((), dtype=angle.dtype, device=angle.device))


def _float_mod(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``jnp.mod`` for floats: truncated remainder shifted to y's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool → (..., 8) int32 words, little-endian within a word
    (the bit pattern of the reference's uint32 words)."""
    words = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    packed = (words << shifts).sum(dim=-1)
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words → (..., 256) uint8 bit matrix."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], 256).to(torch.uint8)


def descriptor_words(descriptors, device=None) -> torch.Tensor:
    """Host descriptors ((..., 8) uint32, as keyframes and snapshots hold
    them) as the int32 words the device ops take, on ``device``."""
    words = np.ascontiguousarray(np.asarray(descriptors, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(words).to(device)


def describe_keypoints(
    image: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    config: BriefConfig = BriefConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steered-BRIEF descriptors for padded keypoints.

    image: (..., H, W) float32 **already blurred**; xy (..., N, 2); valid
    (..., N). Returns ``(descriptors (..., N, 8) int32, angles (..., N))``.
    Invalid slots hold zero descriptors.
    """
    patches = extract_patches(image, xy, out_dtype=torch.bfloat16)  # (..., N, 1024)
    angles = orientations_from_patches(patches, valid)
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=angles.device)
    frac = _float_mod(angles, two_pi) / two_pi
    bins = (torch.round(frac * NUM_ANGLE_BINS).to(torch.int64) % NUM_ANGLE_BINS).clamp(
        0, NUM_ANGLE_BINS - 1
    )
    # All bins for all keypoints in ONE bf16 product: each bank column holds
    # one +1 and one -1, so the response is exactly I(p2) - I(p1) and only
    # its sign survives into the descriptor.
    _, bank = _tables(patches.device)
    resp = (patches @ bank).reshape(*xy.shape[:-1], NUM_ANGLE_BINS, NUM_PAIRS)
    index = bins[..., None, None].expand(*bins.shape, 1, NUM_PAIRS)
    chosen = torch.gather(resp, -2, index)[..., 0, :]
    packed = _pack_bits(chosen > 0)
    packed = torch.where(valid[..., None], packed, torch.zeros((), dtype=packed.dtype, device=packed.device))
    return packed, angles
