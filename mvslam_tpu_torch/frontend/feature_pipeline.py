"""Feature pipeline: detection + description + matching.

Port of ``mvslam_tpu/frontend/feature_pipeline.py``: the configuration,
the fixed-shape :class:`FeatureSet`, and the facade of the reference's six
public names (``FeaturePipelineConfig``, ``MatchStats``,
``FeaturePipeline``, ``build_feature_pipeline``, ``matches_to_points``,
``adaptive_ransac_threshold``). ``FeaturePipeline`` and
``adaptive_ransac_threshold`` run on their ``device`` (default
``"cuda"``): CUDA frames launch kernels K1 and K2, CPU frames take their
plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mvslam_tpu_torch.ops.hamming import (
    MatchConfig,
    SelectedMatches,
    gather_matched_points,
    match_descriptors,
    select_matches,
)
from mvslam_tpu_torch.ops.ransac import adaptive_ransac_threshold as _adaptive_threshold


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


@dataclass(frozen=True)
class MatchStats:
    """Summary of one matching call; same fields as the reference's."""

    num_features_1: int
    num_features_2: int
    num_matches: int
    mean_distance: float
    min_distance: float
    max_distance: float


class FeaturePipeline:
    """Detect/describe/match facade on ``device``."""

    def __init__(self, config: Optional[FeaturePipelineConfig] = None, device="cuda") -> None:
        self.config = config or FeaturePipelineConfig()
        self.device = torch.device(device)
        self._match_config = MatchConfig(
            ratio=self.config.ratio,
            cross_check=self.config.cross_check,
            use_ratio_test=self.config.use_ratio_test,
        )

    def _frames(self, frames) -> torch.Tensor:
        if isinstance(frames, torch.Tensor):
            return frames.to(self.device)
        # A copy: the caller's array may be read-only (a broadcast view),
        # which torch.from_numpy does not take.
        return torch.from_numpy(np.array(frames)).to(self.device)

    def detect_and_describe(self, frame) -> FeatureSet:
        """One frame: (H, W) gray or (H, W, 3) colour, uint8 or float."""
        return FeatureSet(*(a[0] for a in self.detect_and_describe_batch(self._frames(frame)[None])))

    def detect_and_describe_batch(self, frames) -> FeatureSet:
        """(B, H, W[, 3]) frames in ONE batched detect+describe: K1 and K2
        each launch once for all B frames."""
        from mvslam_tpu_torch.slam.tracking import _detect_describe  # slam.tracking imports this module

        return _detect_describe(self._frames(frames), self.config)

    def match(self, features1: FeatureSet, features2: FeatureSet) -> SelectedMatches:
        result = match_descriptors(
            features1.descriptors,
            features1.valid,
            features2.descriptors,
            features2.valid,
            self._match_config,
        )
        return select_matches(result, max_matches=self.config.max_matches)

    def match_stats(self, features1: FeatureSet, features2: FeatureSet, selected: SelectedMatches) -> MatchStats:
        m = selected.valid.cpu().numpy()
        d = selected.distances.cpu().numpy()[m]
        return MatchStats(
            num_features_1=features1.num_valid,
            num_features_2=features2.num_valid,
            num_matches=int(m.sum()),
            mean_distance=float(d.mean()) if len(d) else 0.0,
            min_distance=float(d.min()) if len(d) else 0.0,
            max_distance=float(d.max()) if len(d) else 0.0,
        )


def build_feature_pipeline(config: Optional[FeaturePipelineConfig] = None, device="cuda") -> FeaturePipeline:
    return FeaturePipeline(config, device=device)


def matches_to_points(
    features1: FeatureSet, features2: FeatureSet, selected: SelectedMatches
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Matched (K, 2) point arrays and the (K,) mask; padded slots are zero."""
    p1, p2 = gather_matched_points(features1.xy, features2.xy, selected)
    return p1, p2, selected.valid


def adaptive_ransac_threshold(base_threshold: float, pts1, pts2, mask=None, device="cuda") -> float:
    """Median-displacement-scaled RANSAC threshold (scale = median / 25,
    clipped to [0.5, 2.0]); arrays or tensors, moved to ``device``."""
    pts1 = torch.as_tensor(pts1, dtype=torch.float32, device=device)
    pts2 = torch.as_tensor(pts2, dtype=torch.float32, device=device)
    if mask is None:
        mask = torch.ones(pts1.shape[0], dtype=torch.bool, device=device)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
    return float(_adaptive_threshold(base_threshold, pts1, pts2, mask))
