"""Evaluation: trajectory metrics and telemetry digests (port of ``mvslam_tpu/eval``)."""
