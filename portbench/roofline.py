"""Peaks of the card and the work of each kernel, counted from its shapes.

A kernel's least time is the larger of its bytes over the memory
bandwidth and its operations over the float32 peak. Bytes count each
input read once and each output written once. The counts are of the work
itself, whatever implements it.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet), at its 700 W limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
K1_OPS_PER_PX = 180  # the FAST-9 + NMS kernel's own cost estimate per pixel
TILE_PIXELS = 32 * 32

_SIZES = {"torch.uint8": 1, "torch.float32": 4, "torch.bfloat16": 2}


def least_seconds(nbytes: float, ops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def k1_work(dtype: str, b: int, h: int, w: int):
    """FAST-9 + 3x3 NMS + border of B frames: each pixel read once, the
    suppressed and the raw float32 responses written once; 180 operations
    a pixel."""
    px = b * h * w
    return px * (_SIZES[dtype] + 8), px * K1_OPS_PER_PX


def k2_work(out_dtype: str, b: int, h: int, w: int, n: int):
    """32x32 tiles at N points of B float32 frames: the frames read once
    (whole: at the tracker's 1,000-2,048 points a frame the tiles cover
    nearly all of it), the points read, the tiles written."""
    return b * h * w * 4 + b * n * 2 * 4 + b * n * TILE_PIXELS * _SIZES[out_dtype], 0


def least_seconds_of(shapes, work) -> float:
    """Least seconds of every launch counted in ``shapes`` ({key: count})."""
    return sum(count * least_seconds(*work(*key)) for key, count in shapes.items())
