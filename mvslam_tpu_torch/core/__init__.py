"""Threefry PRNG port, CUDA kernel build, the one-process device mesh
(``sharding``), and the host core: determinism, hashing, run artifacts,
persistence and telemetry (the reference's seven public names)."""

from mvslam_tpu_torch.core.determinism import (
    DeterminismRegistry,
    build_registry,
    hash_config_path,
)
from mvslam_tpu_torch.core.integrity import stable_hash, stable_event_digest
from mvslam_tpu_torch.core.experiments import create_run_artifacts, write_resolved_config

__all__ = [
    "DeterminismRegistry",
    "build_registry",
    "hash_config_path",
    "stable_hash",
    "stable_event_digest",
    "create_run_artifacts",
    "write_resolved_config",
]
