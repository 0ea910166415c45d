"""Hamming matching against the JAX reference: distances, best indices,
cross-check masks and selected pairs all equal, ties included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import random_descriptors, t, to_np

from mvslam_tpu.ops import hamming as jham
from mvslam_tpu_torch.ops import hamming as tham


def _as_port(desc_u32: np.ndarray) -> torch.Tensor:
    return t(desc_u32.view(np.int32))


def _inputs(n, m, seed, ties):
    d1 = random_descriptors(n, seed=seed, duplicate_every=4 if ties else 0)
    d2 = np.concatenate([d1[: m // 2], random_descriptors(m - m // 2, seed=seed + 1)])
    rng = np.random.default_rng(seed)
    # Flip a few bits so distances spread, and duplicate train rows (ties).
    d2[: m // 2] ^= (rng.random((m // 2, 8)) < 0.02).astype(np.uint32) << np.uint32(3)
    if ties:
        rows = np.arange(1, m, 5)
        d2[rows] = d2[rows - 1]
    v1 = rng.random(n) > 0.1
    v2 = rng.random(m) > 0.1
    return d1, v1, d2, v2


def test_distance_matrix_equals_reference():
    d1, _, d2, _ = _inputs(40, 50, 0, ties=False)
    ref = np.asarray(jham.hamming_distance_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    got = to_np(tham.hamming_distance_matrix(_as_port(d1), _as_port(d2)))
    assert np.array_equal(got, ref)
    popcount = np.unpackbits(d1[:, None, :].view(np.uint8) ^ d2[None, :, :].view(np.uint8), axis=-1).sum(-1)
    assert np.array_equal(got, popcount.astype(np.float32))


@pytest.mark.parametrize("ratio_test", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_match_descriptors_equals_reference(ties, ratio_test):
    d1, v1, d2, v2 = _inputs(96, 80, 1, ties)
    jcfg = jham.MatchConfig(use_ratio_test=ratio_test)
    tcfg = tham.MatchConfig(use_ratio_test=ratio_test)
    ref = jham.match_descriptors(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2), jcfg)
    got = tham.match_descriptors(_as_port(d1), t(v1), _as_port(d2), t(v2), tcfg)
    for name in ("indices", "distances", "second_distances", "valid"):
        assert np.array_equal(to_np(getattr(got, name)), np.asarray(getattr(ref, name))), name
    assert to_np(got.valid).sum() > 10


@pytest.mark.parametrize("max_matches", [16, 64, 200])
def test_select_matches_equals_reference(max_matches):
    """Equal distances keep query order (jax.lax.top_k's tie rule); a cap
    above the query count pads."""
    d1, v1, d2, v2 = _inputs(96, 80, 2, ties=True)
    ref = jham.select_matches(
        jham.match_descriptors(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2)),
        max_matches=max_matches,
    )
    got = tham.select_matches(
        tham.match_descriptors(_as_port(d1), t(v1), _as_port(d2), t(v2)), max_matches=max_matches
    )
    for name in ("pairs", "distances", "valid", "num_valid"):
        assert np.array_equal(to_np(getattr(got, name)), np.asarray(getattr(ref, name))), name
    assert got.pairs.dtype == torch.int32


def test_select_matches_tie_order():
    result = tham.MatchResult(
        indices=torch.tensor([4, 3, 2, 1, 0]),
        distances=torch.tensor([5.0, 2.0, 5.0, 2.0, 1.0]),
        second_distances=torch.zeros(5),
        valid=torch.tensor([True, True, True, True, True]),
    )
    sel = tham.select_matches(result, max_matches=4)
    assert sel.pairs[:, 0].tolist() == [4, 1, 3, 0]


def test_gather_matched_points_and_batching_equal_reference():
    d1, v1, d2, v2 = _inputs(64, 64, 3, ties=False)
    rng = np.random.default_rng(3)
    xy1 = rng.uniform(0, 100, size=(64, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 100, size=(64, 2)).astype(np.float32)
    jsel = jham.select_matches(
        jham.match_descriptors(jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2)), 32
    )
    jp1, jp2 = jham.gather_matched_points(jnp.asarray(xy1), jnp.asarray(xy2), jsel)
    # The port batched over a leading axis of 2 identical pairs.
    batch = lambda a: torch.stack([t(a), t(a)])  # noqa: E731
    sel = tham.select_matches(
        tham.match_descriptors(batch(d1.view(np.int32)), batch(v1), batch(d2.view(np.int32)), batch(v2)), 32
    )
    p1, p2 = tham.gather_matched_points(batch(xy1), batch(xy2), sel)
    for b in range(2):
        assert np.array_equal(to_np(p1[b]), np.asarray(jp1))
        assert np.array_equal(to_np(p2[b]), np.asarray(jp2))
