"""Detection, description, matching and RANSAC ops (port of ``mvslam_tpu.ops``;
the reference's fourteen public names).

``cuda_fast`` and ``cuda_patches`` hold the hand-written CUDA kernels K1
and K2 with their plain PyTorch versions."""

from mvslam_tpu_torch.ops.image import gaussian_blur, rgb_to_gray, build_pyramid
from mvslam_tpu_torch.ops.fast import detect_keypoints, FastConfig
from mvslam_tpu_torch.ops.brief import compute_orientations, describe_keypoints, BriefConfig
from mvslam_tpu_torch.ops.hamming import hamming_distance_matrix, match_descriptors, MatchConfig
from mvslam_tpu_torch.ops.ransac import (
    RansacConfig,
    ransac_essential,
    ransac_homography,
)

__all__ = [
    "gaussian_blur",
    "rgb_to_gray",
    "build_pyramid",
    "detect_keypoints",
    "FastConfig",
    "compute_orientations",
    "describe_keypoints",
    "BriefConfig",
    "hamming_distance_matrix",
    "match_descriptors",
    "MatchConfig",
    "RansacConfig",
    "ransac_essential",
    "ransac_homography",
]
