"""The benchmark of mvslam_tpu_torch on one card: see README.md."""
