"""Threefry PRNG port, CUDA kernel build, and the host core: determinism,
hashing, run artifacts, persistence and telemetry."""
