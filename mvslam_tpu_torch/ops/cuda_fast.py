"""Kernel K1: fused FAST-9 response + 3x3 NMS + border mask.

Replaces ``mvslam_tpu/ops/pallas_fast.py::fast_detect_pallas`` (kernel
body ``_detect_kernel`` / ``_score_rows``). The CUDA source is
``csrc/fast_detect.cu``; :func:`fast_detect_plain` is the same function in
plain PyTorch, which CPU tensors take and against which the kernel is
checked on the card.

Semantics: pixels outside the image read as zero (the TPU kernel's zero
halo), where ``ops.fast.fast_score_map``'s reference formulation wraps
circularly. Both agree under the border mask when ``margin >= 4``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from mvslam_tpu_torch.core import cuda_build
from mvslam_tpu_torch.ops.fast import _mask_border, _nms, fast_score_map


def fast_detect_plain(image: torch.Tensor, threshold: float, margin: int = 19):
    """``(detections, raw)`` f32 (B, H, W): zero-tap FAST score, 3x3 NMS
    and border mask, plus the pre-NMS score."""
    raw = fast_score_map(image, threshold, wrap=False)
    return _mask_border(_nms(raw, 1), margin), raw


def fast_detect(image: torch.Tensor, threshold: float, margin: int = 19) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) uint8 or float image → ``(detections, raw)`` f32 (B, H, W).

    CPU tensors take :func:`fast_detect_plain`; CUDA tensors launch the
    kernel (uint8 with an integral threshold scores in int32, every other
    input as float32) on the current stream.
    """
    if image.device.type == "cpu":
        return fast_detect_plain(image, threshold, margin)
    if not image.is_cuda:
        raise ValueError(f"fast_detect: unsupported device {image.device}")
    if image.ndim != 3:
        raise ValueError(f"fast_detect: expected (B, H, W), got {tuple(image.shape)}")
    if margin < 4:
        raise ValueError("fast_detect: margin must be >= 4 (zero taps vs wrap-around)")
    integral = float(threshold).is_integer()
    if image.dtype == torch.uint8 and integral:
        name = "fast_detect_u8"
        thr = int(threshold)
    else:
        name = "fast_detect_f32"
        image = image.to(torch.float32)
        thr = float(threshold)
    image = image.contiguous()
    b, h, w = image.shape
    det = torch.empty((b, h, w), dtype=torch.float32, device=image.device)
    raw = torch.empty_like(det)
    if b * h * w == 0:
        return det, raw
    lib = cuda_build.load()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(
            image.data_ptr(), det.data_ptr(), raw.data_ptr(), b, h, w, thr, int(margin), stream
        )
    cuda_build.check(err, name)
    fast_detect.launches += 1
    return det, raw


fast_detect.launches = 0  # kernel launches (plain-version calls do not count)
