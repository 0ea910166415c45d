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


@pytest.mark.parametrize("n,k", [(300, 64), (5000, 256), (4097, 8)])
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_topk_index_set_equals_jax(seed, n, k):
    """As bow.py's ``_lloyd`` picks its initial centroids: the uniform bits
    are equal, ``log`` may differ from XLA's in the last place (values
    within 1e-6), and the top-k index list, ranked with the stable top-k,
    is the reference's."""
    from mvslam_tpu_torch.ops.fast import topk_stable

    ref = jax.random.gumbel(jax.random.key(seed), (n,))
    got = prng.gumbel(prng.key(seed), (n,))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-6, rtol=0)
    ref_idx = np.asarray(jax.lax.top_k(ref, k)[1])
    assert np.array_equal(to_np(topk_stable(got, k)[1]), ref_idx)


@pytest.mark.parametrize(
    "lo,hi,shape",
    [(0, 2**31 - 1, ()), (0, 10, (5,)), (-5, 70000, (3, 4)), (3, 65536, (7,)), (0, 65537, (9,)), (4, 4, (3,))],
)
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_equals_jax(seed, lo, hi, shape):
    """As map_builder.py draws its numpy seed (``randint(key, (), 0,
    2**31 - 1)``), and at spans on both sides of 2**16, where the wrapping
    multiplier changes."""
    ref = np.asarray(jax.random.randint(jax.random.key(seed), shape, lo, hi))
    got = to_np(prng.randint(prng.key(seed), shape, lo, hi))
    assert got.shape == ref.shape and np.array_equal(got, ref)
