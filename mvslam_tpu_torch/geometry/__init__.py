"""Closed-form small-matrix linear algebra and epipolar geometry (port of ``mvslam_tpu.geometry``)."""
