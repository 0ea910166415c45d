"""The SLAMSystem entry point and the fused tracking step (port of ``mvslam_tpu.slam``)."""
