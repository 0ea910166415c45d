"""The fused tracking step (port of ``mvslam_tpu.slam.tracking``)."""
