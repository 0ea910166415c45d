"""The port's pyramidal Lucas-Kanade (``ops/lk.py``) against the JAX reference.

The cases of ``tests/test_ops.py::TestLucasKanade`` plus pyramids on odd
sizes and on a size whose coarsest level is exactly one 32 px tile high.
Tolerances: ``next_pts`` within 1e-3 px and ``residuals`` within 1e-4
relative (XLA:CPU and torch sum the 21x21 windows in different orders);
``valid`` equal except where the reference sits on a gate: residual within
1e-3 of ``max_residual`` or det within 1e-3 of ``min_determinant``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import t, to_np

from mvslam_tpu.ops import image as jimage
from mvslam_tpu.ops import lk as jlk
from mvslam_tpu_torch.ops import cuda_patches
from mvslam_tpu_torch.ops import lk as tlk


def _textured(h=160, w=220, seed=9, blobs=60):
    """tests/test_ops.py's LK image: bright blobs, lightly smoothed."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 30, size=(h, w)).astype(np.float32)
    for _ in range(blobs):
        y, x = rng.integers(20, h - 26), rng.integers(20, w - 26)
        s = rng.integers(3, 7)
        img[y : y + s, x : x + s] = rng.uniform(120, 255)
    return np.asarray(jimage.gaussian_blur(jnp.asarray(img), sigma=1.0, radius=2))


def _reference_det(prev, pts, config):
    """det of the reference's finest-level normal matrix per point."""
    img = jnp.asarray(prev, jnp.float32)
    if config.blur_sigma > 0:
        img = jimage.gaussian_blur(img, sigma=config.blur_sigma, radius=2)
    tw, _ = jlk._bilinear_windows(img, jnp.asarray(pts), pad=1)
    tw = np.asarray(tw, np.float64)
    ix = 0.5 * (tw[:, 1:-1, 2:] - tw[:, 1:-1, :-2])
    iy = 0.5 * (tw[:, 2:, 1:-1] - tw[:, :-2, 1:-1])
    gxx, gxy, gyy = (ix * ix).sum((1, 2)), (ix * iy).sum((1, 2)), (iy * iy).sum((1, 2))
    return gxx * gyy - gxy * gxy


def _points(rng, n, h, w, border=0.0):
    return np.stack(
        [rng.uniform(-border, w + border, n), rng.uniform(-border, h + border, n)], axis=-1
    ).astype(np.float32)


def _case(name):
    """(prev, next, pts, mask, config kwargs) of one named case."""
    rng = np.random.default_rng(1)
    if name == "integer_translation":
        img = _textured()
        nxt = np.roll(np.roll(img, -3, axis=0), 5, axis=1)
        pts = np.stack([rng.uniform(40, 180, 64), rng.uniform(40, 120, 64)], axis=-1).astype(np.float32)
        return img, nxt, pts, np.ones(64, bool), dict(num_levels=3, iterations=10)
    if name == "subpixel_translation":
        img = _textured(seed=12)
        nxt = 0.5 * img + 0.5 * np.roll(img, -1, axis=1)  # content moved left by 0.5 px
        pts = np.stack([rng.uniform(40, 180, 48), rng.uniform(40, 120, 48)], axis=-1).astype(np.float32)
        return img, nxt, pts, np.ones(48, bool), dict(num_levels=2, iterations=10)
    if name == "flat_regions":
        img = np.full((128, 160), 50.0, dtype=np.float32)
        pts = np.array([[80.0, 64.0], [40.0, 40.0]], dtype=np.float32)
        return img, img, pts, np.ones(2, bool), dict(num_levels=1, iterations=4)
    if name == "border_points":
        img = _textured()
        h, w = img.shape
        pts = np.array([[w - 15.0, h / 2], [w / 2, h - 14.0], [w / 2, h / 2]], dtype=np.float32)
        return img, img, pts, np.ones(3, bool), dict(num_levels=1, iterations=2)
    if name == "odd_size_three_levels":
        # 130x170 → 65x85 → 32x42: odd sizes drop a row/column per level.
        img = _textured(130, 170, seed=4, blobs=50)
        nxt = np.roll(np.roll(img, 2, axis=0), -4, axis=1)
        pts = _points(rng, 200, 130, 170, border=12.0)
        mask = rng.uniform(size=200) > 0.1
        return img, nxt, pts, mask, dict(num_levels=3, iterations=8)
    if name == "one_tile_coarsest_level":
        # 128x160 → 64x80 → 32x40: the coarsest level is K2's minimum size.
        img = _textured(128, 160, seed=5, blobs=40)
        nxt = np.roll(img, 3, axis=1)
        pts = _points(rng, 150, 128, 160, border=8.0)
        return img, nxt, pts, np.ones(150, bool), dict(num_levels=3)
    raise KeyError(name)


CASES = [
    "integer_translation",
    "subpixel_translation",
    "flat_regions",
    "border_points",
    "odd_size_three_levels",
    "one_tile_coarsest_level",
]


@pytest.mark.parametrize("name", CASES)
def test_lk_track_equals_reference(name):
    prev, nxt, pts, mask, kw = _case(name)
    jcfg, tcfg = jlk.LKConfig(**kw), tlk.LKConfig(**kw)
    jp, jr, jv = (
        np.asarray(a)
        for a in jlk.lk_track(jnp.asarray(prev), jnp.asarray(nxt), jnp.asarray(pts), jnp.asarray(mask), jcfg)
    )
    tp, tr, tv = (to_np(a) for a in tlk.lk_track(t(prev), t(nxt), t(pts), t(mask), tcfg))
    assert np.abs(tp - jp).max() <= 1e-3
    assert np.abs(tr - jr).max() <= 1e-4 * max(1.0, np.abs(jr).max())
    det = _reference_det(prev, pts, tcfg)
    on_gate = (np.abs(jr - tcfg.max_residual) < 1e-3) | (np.abs(det - tcfg.min_determinant) < 1e-3)
    assert np.array_equal(tv[~on_gate], jv[~on_gate])
    if name in ("integer_translation", "subpixel_translation", "odd_size_three_levels", "one_tile_coarsest_level"):
        assert jv.sum() >= 30  # the comparison covers converged tracks
    if name == "flat_regions":
        assert not tv.any()
    if name == "border_points":
        assert list(tv) == [False, False, True]


def test_lk_recovers_translation():
    """The port alone recovers the integer shift, as the reference's test asks."""
    prev, nxt, pts, mask, kw = _case("integer_translation")
    nxt_pts, _, valid = (to_np(a) for a in tlk.lk_track(t(prev), t(nxt), t(pts), t(mask), tlk.LKConfig(**kw)))
    assert valid.sum() >= 40
    err = np.abs(nxt_pts[valid] - pts[valid] - np.array([5.0, -3.0]))
    assert np.median(err) < 0.25


def test_lk_tiles_come_from_k2_wrapper(monkeypatch):
    """Every window is cut by K2's wrapper, f32 out, one call for all points
    per template, per iteration and per final residual: levels × (iters + 2)."""
    calls = []
    real = cuda_patches.extract_patches

    def spy(image, xy, out_dtype=None):
        calls.append((tuple(image.shape), tuple(xy.shape), out_dtype))
        return real(image, xy, out_dtype=out_dtype)

    monkeypatch.setattr(cuda_patches, "extract_patches", spy)
    prev, nxt, pts, mask, _ = _case("odd_size_three_levels")
    tlk.lk_track(t(prev), t(nxt), t(pts), t(mask), tlk.LKConfig(num_levels=3, iterations=8))
    assert len(calls) == 3 * (8 + 2)
    assert {c[0] for c in calls} == {(1, 130, 170), (1, 65, 85), (1, 32, 42)}
    assert all(c[1] == (1, 200, 2) and c[2] == torch.float32 for c in calls)


def test_lk_config_equals_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(tlk.LKConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(jlk.LKConfig)
    ]
    assert tlk.LKConfig.__dataclass_params__.frozen
