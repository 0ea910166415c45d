"""Back end: keyframe policy (port of ``mvslam_tpu/backend``)."""
