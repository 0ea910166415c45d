"""Sample-media helpers for demos.

Parity: reference ``demo_utils.py`` — download the sample drive video on
demand (ref L19-35). Without network access the download fails with an
actionable error; a local synthetic generator is the fallback for offline
demos.

Copied close to verbatim from ``mvslam_tpu/data/demo_utils.py``.
"""

from __future__ import annotations

import logging
import urllib.request
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

SAMPLE_VIDEO_URL = "https://github.com/udacity/self-driving-car/raw/master/datasets/NVidiaRun2.mp4"
DEFAULT_CACHE = Path.home() / ".cache" / "mvslam_tpu_torch" / "NVidiaRun2.mp4"


def ensure_sample_video(path: Optional[Path] = None, url: str = SAMPLE_VIDEO_URL) -> Path:
    """Return a local sample video path, downloading it when absent.

    Parity: ``demo_utils.py:19-35``. Raises RuntimeError with guidance in
    air-gapped environments.
    """
    target = Path(path) if path is not None else DEFAULT_CACHE
    if target.exists() and target.stat().st_size > 0:
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    try:
        logger.info("downloading sample video", extra={"url": url})
        urllib.request.urlretrieve(url, target)  # noqa: S310
        return target
    except Exception as exc:
        raise RuntimeError(
            f"could not download sample video ({exc}); provide a local file via "
            f"--input, or generate a synthetic clip with generate_synthetic_video()"
        ) from exc


def generate_synthetic_video(
    path: Path, num_frames: int = 60, h: int = 240, w: int = 320, seed: int = 0
) -> Path:
    """Offline fallback: write a textured translating clip (cv2 gated)."""
    import cv2

    rng = np.random.default_rng(seed)
    shift = 4
    base = rng.uniform(0, 40, size=(h, w + shift * num_frames)).astype(np.float32)
    for _ in range(300):
        y = rng.integers(20, h - 26)
        x = rng.integers(20, base.shape[1] - 26)
        s = rng.integers(3, 9)
        base[y : y + s, x : x + s] = rng.uniform(120, 255)
    half = h // 2
    writer = cv2.VideoWriter(
        str(path), cv2.VideoWriter_fourcc(*"mp4v"), 20.0, (w, h), isColor=False
    )
    try:
        for i in range(num_frames):
            top = base[:half, (i * shift) // 2 : (i * shift) // 2 + w]
            bottom = base[half:, i * shift : i * shift + w]
            writer.write(np.concatenate([top, bottom], axis=0).astype(np.uint8))
    finally:
        writer.release()
    return Path(path)
