"""The port's bag-of-words place recognition against the JAX package's, on
real BRIEF descriptors of rendered frames.

The E-step's product has bf16 operands and a float32 sum in both packages;
only the order of that sum differs, so assignments agree except where a
descriptor's two best distances are within 1e-3, and everything downstream
of equal assignments (M-step, histograms) is exact in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_parity import desc_u32, t, to_np

from mvslam_tpu.data.synthetic import render_scene
from mvslam_tpu.loopclosure import bow as jbow
from mvslam_tpu.loopclosure.device_index import DeviceBoWIndex as JDeviceBoWIndex
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
from mvslam_tpu_torch.loopclosure import bow as tbow
from mvslam_tpu_torch.loopclosure.device_index import DeviceBoWIndex
from mvslam_tpu_torch.ops.brief import unpack_bits
from mvslam_tpu_torch.slam.tracking import bootstrap_frame

NUM_FRAMES = 10
PER_FRAME = 512


@pytest.fixture(scope="module")
def keyframes():
    """(descriptors uint32 (512, 8), valid) of ten rendered frames, from the
    port's detector (bit-equal to the reference's)."""
    frames, _, _, _ = render_scene(num_frames=NUM_FRAMES, h=240, w=320, seed=5, noise=3.0)
    out = []
    for f in frames:
        feats = bootstrap_frame(torch.from_numpy(f), FeaturePipelineConfig(num_features=PER_FRAME, max_matches=128))
        out.append((desc_u32(feats.descriptors), to_np(feats.valid)))
    return out


@pytest.fixture(scope="module")
def descriptors(keyframes):
    d = np.concatenate([d[v] for d, v in keyframes])
    assert len(d) >= 4000
    return d[:4000]


@pytest.fixture(scope="module")
def ref_vocabulary(descriptors):
    return jbow.train_vocabulary(descriptors, jax.random.key(11), vocab_size=64, iterations=15)


def _bits(desc):
    return unpack_bits(t(np.ascontiguousarray(desc).view(np.int32)))


def _ref_distances(x, c):
    """The reference's E-step matrix, recomputed with its own expression."""
    dots = jax.lax.dot_general(
        x.astype(jnp.bfloat16), c.astype(jnp.bfloat16), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return np.asarray(jnp.sum(x * x, 1)[:, None] + jnp.sum(c * c, 1)[None, :] - 2.0 * dots)


def test_config_equals_reference():
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(tbow.BoWConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jbow.BoWConfig)
    ]


def test_bf16_product_returns_float32():
    """The dot of bf16-rounded operands is summed and returned in float32:
    rounding the dot itself to bf16 (what a bf16 matmul does in PyTorch)
    would be off by up to 2^-8 of its value."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.uniform(size=(64, 256)) > 0.5).astype(np.float32))
    c = torch.from_numpy(rng.uniform(size=(32, 256)).astype(np.float32))
    dots = tbow._bf16_dots(x, c)
    assert dots.dtype == torch.float32
    exact = x.double() @ c.bfloat16().double().T
    assert (dots.double() - exact).abs().max() < 1e-3  # f32 summation error only
    rounded = (x.bfloat16() @ c.bfloat16().T).float()
    assert (rounded.double() - exact).abs().max() > 0.05  # what is avoided
    assert not torch.equal(dots, rounded)


def test_e_step_assigns_as_reference(descriptors, ref_vocabulary):
    """One E-step from the same centroids: equal assignments except where a
    descriptor's two best distances differ by < 1e-3."""
    bits = _bits(descriptors)
    x = bits.to(torch.float32)
    got = to_np(tbow._assign(x, (x * x).sum(1), t(ref_vocabulary)))
    d = _ref_distances(jnp.asarray(to_np(x)), jnp.asarray(ref_vocabulary))
    ref = d.argmin(1)
    two = np.sort(d, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) >= 1e-3
    assert clear.mean() > 0.95
    assert np.array_equal(got[clear], ref[clear])


def test_argmin_takes_first_minimum_on_ties():
    """Duplicate centroids: both packages assign to the lower index."""
    rng = np.random.default_rng(1)
    c = (rng.uniform(size=(8, 256)) > 0.5).astype(np.float32)
    c[5] = c[2]
    x = torch.from_numpy(c[[2, 5, 0, 7]].copy())
    got = to_np(tbow._assign(x, (x * x).sum(1), torch.from_numpy(c)))
    assert got.tolist() == [2, 2, 0, 7]


def test_train_vocabulary_equals_reference(descriptors, ref_vocabulary):
    """4,000 real descriptors, 64 words, 15 iterations: within 1e-4, or,
    where a near-tied assignment flipped on the way, the two vocabularies
    give histograms with cosine >= 0.999."""
    got = tbow.train_vocabulary(descriptors, prng.key(11), vocab_size=64, iterations=15, device="cpu")
    assert got.shape == ref_vocabulary.shape == (64, 256) and got.dtype == np.float32
    if np.abs(got - ref_vocabulary).max() <= 1e-4:
        return
    for start in range(0, 4000, 500):
        d = descriptors[start : start + 500]
        v = np.ones(len(d), bool)
        a = tbow.compute_bow_histogram(d, v, got, device="cpu")
        b = tbow.compute_bow_histogram(d, v, ref_vocabulary, device="cpu")
        assert float(a @ b) >= 0.999


def test_train_vocabulary_needs_enough_descriptors(descriptors):
    with pytest.raises(ValueError, match="need >= 64"):
        tbow.train_vocabulary(descriptors[:10], prng.key(0), vocab_size=64, device="cpu")


def test_histogram_equals_reference(keyframes, ref_vocabulary):
    """Given the reference's vocabulary: within 1e-6 (the counts are exact
    integers wherever the assignments agree)."""
    for d, v in keyframes[:4]:
        ref = jbow.compute_bow_histogram(d, v, ref_vocabulary)
        got = tbow.compute_bow_histogram(d, v, ref_vocabulary, device="cpu")
        assert got.dtype == np.float32 and got.shape == (64,)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    empty = tbow.compute_bow_histogram(keyframes[0][0], np.zeros(PER_FRAME, bool), ref_vocabulary, device="cpu")
    assert np.array_equal(empty, np.zeros(64, np.float32))


def _databases(ref_vocabulary, **cfg):
    ours = tbow.BoWDatabase(tbow.BoWConfig(vocab_size=64, **cfg), key=prng.key(3), device="cpu")
    ref = jbow.BoWDatabase(jbow.BoWConfig(vocab_size=64, **cfg), key=jax.random.key(3))
    ours.vocabulary = ref_vocabulary
    ref.vocabulary = ref_vocabulary
    return ours, ref


@pytest.mark.parametrize("device_index_capacity", [0, 4])
def test_database_hits_equal_reference(keyframes, ref_vocabulary, device_index_capacity):
    """A sequence of keyframes out and back (frame 10 + i shows frame
    9 − i again) through ``process_keyframe``, ``rank`` and
    ``detect_loop``, host ranking and device index (capacity 4, so it
    grows): the reference's hits, scores within 1e-6."""
    ours, ref = _databases(
        ref_vocabulary, similarity_threshold=0.6, min_frame_gap=4, device_index_capacity=device_index_capacity
    )
    sequence = keyframes + keyframes[::-1]
    hits = 0
    for fid, (d, v) in enumerate(sequence):
        a, b = ours.process_keyframe(fid, d, v), ref.process_keyframe(fid, d, v)
        assert (a is None) == (b is None)
        if a is not None:
            hits += 1
            assert a[0] == b[0] and abs(a[1] - b[1]) < 1e-6
    assert hits >= 5 and ours.frame_ids == ref.frame_ids
    d, v = keyframes[3]
    ra, rb = ours.rank(d, v), ref.rank(d, v)
    assert [f for f, _ in ra] == [f for f, _ in rb]
    np.testing.assert_allclose([s for _, s in ra], [s for _, s in rb], atol=1e-6)
    a, b = ours.detect_loop(40, d, v), ref.detect_loop(40, d, v)
    assert a is not None and a[0] == b[0] and abs(a[1] - b[1]) < 1e-6
    assert np.array_equal(ours.export_vocabulary(), ref_vocabulary)


def test_database_trains_once_enough_descriptors_are_pending(keyframes):
    """Untrained databases buffer frames and train at the same frame in
    both packages; afterwards every pending frame is recorded."""
    cfg = dict(vocab_size=64, min_train_descriptors_factor=20, kmeans_iterations=3)
    ours = tbow.BoWDatabase(tbow.BoWConfig(**cfg), key=prng.key(3), device="cpu")
    ref = jbow.BoWDatabase(jbow.BoWConfig(**cfg), key=jax.random.key(3))
    for fid, (d, v) in enumerate(keyframes[:5]):
        ours.add_frame(fid, d, v)
        ref.add_frame(fid, d, v)
        assert ours.is_trained == ref.is_trained
    assert ours.is_trained and ours.frame_ids == ref.frame_ids == list(range(5))
    assert ours.vocabulary.shape == (64, 256)


def test_device_index_topk_equals_host_ranking():
    """Ties across the cutoff included: duplicated rows score equal, and
    the lower frame id wins on the device as on the host."""
    rng = np.random.default_rng(7)
    h = rng.uniform(size=(40, 32)).astype(np.float32)
    h[10] = h[3]
    h[25] = h[3]
    h /= np.linalg.norm(h, axis=1, keepdims=True)
    ids = list(range(0, 80, 2))
    index = DeviceBoWIndex(32, 8, device="cpu")
    ref = JDeviceBoWIndex(32, 8)
    for i, row in zip(ids, h):
        index.add(i, row)
        ref.add(i, row)
    assert len(index) == 40 and index.capacity == ref.capacity == 64
    bulk = DeviceBoWIndex.from_histograms(ids, h, device="cpu")
    for q in (h[3], h[17], rng.uniform(size=32).astype(np.float32)):
        scores = h @ q
        np.testing.assert_allclose(index.scores(q), scores, atol=1e-6)
        for k in (1, 2, 3, 16, 64):
            host = sorted(range(40), key=lambda i: (-float(index.scores(q)[i]), ids[i]))[:k]
            got = index.topk(q, k=k)
            assert [f for f, _ in got] == [ids[i] for i in host]
            assert [f for f, _ in bulk.topk(q, k=k)] == [f for f, _ in got]
            assert [f for f, _ in ref.topk(q, k=k)] == [f for f, _ in got]
    top3 = [f for f, _ in index.topk(h[3], k=2)]
    assert top3 == [6, 20]  # rows 3 and 10 tie; row 25 ties too and is cut


def test_device_index_refuses_out_of_order_ids():
    index = DeviceBoWIndex(4, 2, device="cpu")
    index.add(5, np.ones(4, np.float32) / 2)
    with pytest.raises(ValueError, match="strictly increasing"):
        index.add(5, np.ones(4, np.float32) / 2)
    with pytest.raises(ValueError, match="strictly increasing"):
        DeviceBoWIndex.from_histograms([1, 3, 2], np.zeros((3, 4), np.float32), device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        DeviceBoWIndex.from_histograms([1, 2, 3], np.zeros((3, 4), np.float32), capacity=2, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        DeviceBoWIndex(4, 0, device="cpu")
    assert DeviceBoWIndex(4, 2, device="cpu").topk(np.ones(4, np.float32)) == []


def test_no_float_atomics_in_the_new_assemblies():
    """The M-step, the histogram and the index never add with
    ``index_add_``/``scatter_add_`` (float atomics on CUDA)."""
    import inspect

    from mvslam_tpu_torch.loopclosure import device_index, map_builder, persistent_map
    from mvslam_tpu_torch.slam import offline

    for mod in (tbow, device_index, map_builder, persistent_map, offline):
        src = inspect.getsource(mod)
        code = "\n".join(line.split("#")[0] for line in src.splitlines() if not line.lstrip().startswith(("#", '"', "-", "`")))
        for name in ("index_add", "scatter_add", "index_put", "bincount", "scatter_reduce"):
            assert name + "(" not in code and name + "_(" not in code, (mod.__name__, name)
