"""Synthetic scene rendering (port of ``mvslam_tpu/data``)."""
