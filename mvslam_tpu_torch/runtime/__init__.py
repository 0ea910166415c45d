"""Host runtime: frame ingestion, the async decode pipeline, the feature
and tracking control planes, the hub, supervisor and failure injection
(port of ``mvslam_tpu/runtime``)."""
