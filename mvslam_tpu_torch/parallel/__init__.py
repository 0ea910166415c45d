"""Device-mesh scaling of the tracking, RANSAC and back-end steps (port of
``mvslam_tpu.parallel``; a one-process mesh of device slots)."""

from mvslam_tpu_torch.parallel.mesh import (
    make_mesh,
    batched_track_pairs,
    run_bundle_adjustment_sharded,
    sharded_ransac_essential,
    solve_problem_sharded,
    track_superwindow_meshed,
)

__all__ = [
    "make_mesh",
    "batched_track_pairs",
    "run_bundle_adjustment_sharded",
    "sharded_ransac_essential",
    "solve_problem_sharded",
    "track_superwindow_meshed",
]
