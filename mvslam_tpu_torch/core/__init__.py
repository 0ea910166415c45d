"""Threefry PRNG port and the CUDA kernel build (``core.prng``, ``core.cuda_build``)."""
