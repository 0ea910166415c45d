"""Back end: keyframe policy, factor graphs, Gauss-Newton solvers, pose graphs, optimization supervision and window bundle adjustment (port of ``mvslam_tpu/backend``)."""
