"""The port's threefry2x32 PRNG against jax.random: bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import to_np

from mvslam_tpu_torch.core import prng

SEEDS = [0, 42, 2**31 - 1]
SHAPES = [(5,), (64, 33), (3, 4, 7)]


def _jax_words(k):
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_equals_jax(seed):
    assert np.array_equal(to_np(prng.key(seed)), _jax_words(jax.random.key(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_equals_jax(seed):
    ref = _jax_words(jax.random.split(jax.random.key(seed)))
    assert np.array_equal(to_np(prng.split(prng.key(seed))), ref)
    # Batched keys split row by row.
    keys = prng.fold_in(prng.key(seed), torch.arange(3))
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(jnp.arange(3))
    assert np.array_equal(to_np(prng.split(keys)), _jax_words(jax.vmap(jax.random.split)(jkeys)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_equals_jax(seed):
    """Per-frame keys as tracking.py:228 folds them: global frame ids."""
    ids = 1 + jnp.arange(16)
    ref = _jax_words(jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(ids))
    assert np.array_equal(to_np(prng.fold_in(prng.key(seed), 1 + torch.arange(16))), ref)
    assert np.array_equal(
        to_np(prng.fold_in(prng.key(seed), 2**32 - 1)),
        _jax_words(jax.random.fold_in(jax.random.key(seed), np.uint32(2**32 - 1))),
    )


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_equals_jax(seed, shape):
    """As ransac.py:84 draws: minval 1e-12, maxval 1 — every bit equal."""
    k = jax.random.fold_in(jax.random.key(seed), 7)
    ref = np.asarray(jax.random.uniform(k, shape, minval=1e-12, maxval=1.0))
    got = to_np(prng.uniform(prng.fold_in(prng.key(seed), 7), shape, minval=1e-12, maxval=1.0))
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_uniform_batched_keys_equal_per_key_draws():
    keys = prng.fold_in(prng.key(3), torch.arange(4))
    batched = to_np(prng.uniform(keys, (8, 16)))
    for i in range(4):
        ref = np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.key(3), i), (8, 16)))
        assert np.array_equal(batched[i], ref)
