"""Bit-exact port of JAX's threefry2x32 PRNG (partitionable mode).

RANSAC draws its minimal samples from ``uniform`` bits; the port reproduces
``jax.random`` bit for bit so a tracked sequence samples the same
hypotheses as the reference. Implements the ``jax_threefry_partitionable``
scheme: ``split`` and ``random_bits`` hash a 64-bit iota split into
(hi, lo) 32-bit counter words, and 32-bit bits are ``out0 ^ out1``.

A key is an int64 tensor of shape ``(..., 2)`` holding two uint32 words.
All arithmetic runs in int64 masked to 32 bits: torch has no usable
uint32 shifts or arange on the CPU.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block hash (20 rounds), broadcasting all inputs."""
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x0 = (x0 + k1) & _MASK
    x1 = (x1 + k2) & _MASK
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & _MASK
        x1 = (x1 + ks[(step + 2) % 3] + step + 1) & _MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` as raw (2,) words: (seed >> 32, seed & mask)."""
    seed = int(seed)
    hi = (seed >> 32) & _MASK if seed >= 0 else 0
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: hash the counter pair (0, uint32(data)).

    ``data`` may be a tensor; the result has shape ``data.shape + k.shape``
    (one key per element) when ``k`` is a single key.
    """
    data = torch.as_tensor(data, dtype=torch.int64, device=k.device) & _MASK
    k1, k2 = k[..., 0], k[..., 1]
    a, b = threefry2x32(k1, k2, torch.zeros_like(data), data)
    return torch.stack([a, b], dim=-1)


def _iota_words(shape, device):
    n = 1
    for s in shape:
        n *= s
    lo = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return lo >> 32, lo & _MASK


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (fold-like form): (..., num, 2) keys."""
    hi, lo = _iota_words((num,), k.device)
    k1, k2 = k[..., 0, None], k[..., 1, None]
    a, b = threefry2x32(k1, k2, hi, lo)
    return torch.stack([a, b], dim=-1)


def random_bits32(k: torch.Tensor, shape) -> torch.Tensor:
    """(..., *shape) uint32 words as int64, for keys of shape (..., 2)."""
    shape = tuple(shape)
    hi, lo = _iota_words(shape, k.device)
    pad = (None,) * len(shape)
    k1 = k[(..., 0) + pad]
    k2 = k[(..., 1) + pad]
    a, b = threefry2x32(k1, k2, hi, lo)
    return a ^ b


def uniform(k: torch.Tensor, shape, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: 23 random mantissa bits in [1, 2),
    minus one, scaled into [minval, maxval)."""
    bits = random_bits32(k, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.gumbel`` in float32: ``-log(-log(u))`` with ``u`` the
    uniform draw on [tiny, 1). The uniform bits equal JAX's; ``log`` may
    differ from XLA's in the last place, so rank the result with a stable
    top-k when the selected index set has to equal the reference's."""
    tiny = float(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(uniform(k, shape, minval=tiny, maxval=1.0)))


def randint(k: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds: the key is split, each half
    draws one 32-bit word per element, and the two words are combined
    modulo the span in wrapping uint32 arithmetic (so the multiplier
    ``2**32 % span`` comes out 0 for spans above 2**16, as in JAX).
    Returns int64 values in [minval, maxval)."""
    minval, maxval = int(minval), int(maxval)
    if not (-(2**31) <= minval and maxval <= 2**31 - 1):
        raise ValueError("randint is ported for bounds within int32")
    keys = split(k, 2)
    higher = random_bits32(keys[..., 0, :], shape)
    lower = random_bits32(keys[..., 1, :], shape)
    span = maxval - minval if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = (((higher % span) * multiplier) & _MASK) + (lower % span)
    return minval + (offset & _MASK) % span
