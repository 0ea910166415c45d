"""Feature pipeline configuration and the fixed-shape feature set.

Port of the tracking step's part of ``mvslam_tpu/frontend/feature_pipeline.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class FeaturePipelineConfig:
    """Same fields and defaults as the reference's config."""

    detector: str = "fast_brief"
    num_features: int = 2048  # padded static keypoint budget
    fast_threshold: float = 20.0
    grid_cells: int = 8
    use_ratio_test: bool = False
    ratio: float = 0.8
    cross_check: bool = True
    max_matches: int = 512
    blur_sigma: float = 2.0
    num_pyramid_levels: int = 1  # levels share the keypoint budget

    def __post_init__(self):
        if self.num_features <= 0:
            raise ValueError("num_features must be positive")
        if not 0.0 < self.ratio <= 1.0:
            raise ValueError("ratio must be in (0, 1]")
        if self.max_matches <= 0:
            raise ValueError("max_matches must be positive")
        if self.detector not in ("fast_brief", "orb"):
            raise ValueError(f"unknown detector {self.detector!r}")
        if self.num_pyramid_levels < 1:
            raise ValueError("num_pyramid_levels must be >= 1")


class FeatureSet(NamedTuple):
    """Fixed-shape detection result, batched over any leading axes."""

    xy: torch.Tensor  # (..., N, 2) float32 (x, y)
    scores: torch.Tensor  # (..., N)
    descriptors: torch.Tensor  # (..., N, 8) int32: bits of the packed 256-bit BRIEF words
    angles: torch.Tensor  # (..., N) float32 radians
    valid: torch.Tensor  # (..., N) bool

    @property
    def num_valid(self) -> int:
        return int(self.valid.sum())
