"""Front end: feature pipeline and robust pose estimation (port of
``mvslam_tpu/frontend``; the reference's eleven public names)."""

from mvslam_tpu_torch.frontend.feature_pipeline import (
    FeaturePipeline,
    FeaturePipelineConfig,
    FeatureSet,
    MatchStats,
    adaptive_ransac_threshold,
    build_feature_pipeline,
    matches_to_points,
)
from mvslam_tpu_torch.frontend.pose_estimator import (
    PoseEstimate,
    PoseEstimationFailure,
    RobustPoseEstimator,
    RobustPoseEstimatorConfig,
)

__all__ = [
    "FeaturePipeline",
    "FeaturePipelineConfig",
    "FeatureSet",
    "MatchStats",
    "adaptive_ransac_threshold",
    "build_feature_pipeline",
    "matches_to_points",
    "PoseEstimate",
    "PoseEstimationFailure",
    "RobustPoseEstimator",
    "RobustPoseEstimatorConfig",
]
