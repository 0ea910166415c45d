"""Closed-form small-matrix linear algebra, epipolar geometry, projection,
Lie maps and alignment (port of ``mvslam_tpu.geometry``; the reference's
sixteen public names)."""

from mvslam_tpu_torch.geometry.lie import (
    so3_exp,
    so3_log,
    se3_exp,
    se3_log,
    se3_matrix,
    se3_inverse,
    se3_relative,
    se2_matrix,
    se2_params,
    sim3_matrix,
    sim3_params,
)
from mvslam_tpu_torch.geometry.projection import (
    make_K,
    project_points,
    triangulate_dlt,
    triangulate_pair,
)
from mvslam_tpu_torch.geometry.alignment import umeyama_alignment

__all__ = [
    "so3_exp",
    "so3_log",
    "se3_exp",
    "se3_log",
    "se3_matrix",
    "se3_inverse",
    "se3_relative",
    "se2_matrix",
    "se2_params",
    "sim3_matrix",
    "sim3_params",
    "make_K",
    "project_points",
    "triangulate_dlt",
    "triangulate_pair",
    "umeyama_alignment",
]
