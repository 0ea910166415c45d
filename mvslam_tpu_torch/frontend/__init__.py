"""Feature-pipeline configuration and robust pose estimation (port of ``mvslam_tpu.frontend``)."""
