"""Host runtime: frame ingestion (port of ``mvslam_tpu/runtime``)."""
