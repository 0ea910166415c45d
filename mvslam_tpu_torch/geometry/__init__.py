"""Closed-form small-matrix linear algebra, epipolar geometry, projection, Lie maps and alignment (port of ``mvslam_tpu.geometry``)."""
