"""FAST detection and kernel K1's plain version against the JAX reference.

The JAX side runs as ``tests/test_ops.py`` runs it on the CPU: the XLA
formulation, and the Pallas kernel under ``force_tpu_interpret_mode``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from torch_parity import t, textured_image, to_np

from mvslam_tpu.ops import fast as jfast
from mvslam_tpu.ops.pallas_fast import fast_detect_pallas
from mvslam_tpu_torch.ops import cuda_fast
from mvslam_tpu_torch.ops import fast as tfast


def _image(kind):
    img = textured_image(h=96, w=160, seed=3)
    # "float32" has non-integral values: the f32 path, summed in circle order.
    return img.astype(np.uint8) if kind == "uint8" else img


@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_score_map_equals_reference(kind):
    img = _image(kind)
    ref = np.asarray(jfast.fast_score_map(jnp.asarray(img), 20.0))
    got = to_np(tfast.fast_score_map(t(img), 20.0))
    assert (ref > 0).sum() > 50
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_nms_and_border_equal_reference(kind):
    raw = np.asarray(jfast.fast_score_map(jnp.asarray(_image(kind)), 20.0))
    ref = np.asarray(jfast._mask_border(jfast._nms(jnp.asarray(raw), 1), 19))
    got = to_np(tfast._mask_border(tfast._nms(t(raw), 1), 19))
    assert np.array_equal(got, ref)


def test_nms_keeps_plateaus():
    """The >= tie rule: equal neighbours both survive."""
    score = torch.zeros((8, 8))
    score[3, 3] = score[3, 4] = 5.0
    kept = tfast._nms(score, 1)
    assert kept[3, 3] == 5.0 and kept[3, 4] == 5.0


@pytest.mark.parametrize("grid_cells", [0, 8])
@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_detect_keypoints_equals_reference(kind, grid_cells):
    img = _image(kind)
    jxy, jscores, jvalid = jfast.detect_keypoints(
        jnp.asarray(img), num_keypoints=128, config=jfast.FastConfig(grid_cells=grid_cells)
    )
    xy, scores, valid = tfast.detect_keypoints(
        t(img), num_keypoints=128, config=tfast.FastConfig(grid_cells=grid_cells)
    )
    jvalid = np.asarray(jvalid)
    assert jvalid.sum() > 20
    assert np.array_equal(to_np(valid), jvalid)
    # Integer positions equal; subpixel offsets within 1e-6.
    assert np.array_equal(np.round(to_np(xy)), np.round(np.asarray(jxy)))
    assert np.abs(to_np(xy) - np.asarray(jxy)).max() <= 1e-6
    assert np.array_equal(to_np(scores), np.asarray(jscores))


def test_detect_keypoints_batched_equals_per_frame():
    imgs = np.stack([textured_image(h=96, w=160, seed=s).astype(np.uint8) for s in range(3)])
    cfg = tfast.FastConfig(grid_cells=4)
    xy, _, valid = tfast.detect_keypoints(t(imgs), num_keypoints=64, config=cfg)
    for i in range(3):
        xy_i, _, valid_i = tfast.detect_keypoints(t(imgs[i]), num_keypoints=64, config=cfg)
        assert torch.equal(xy[i], xy_i) and torch.equal(valid[i], valid_i)


def test_topk_ties_take_lower_index_first():
    """jax.lax.top_k order on ties — torch.topk promises none."""
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0]], np.float32)
    vals, idx = tfast.topk_stable(t(x), 4)
    import jax

    jvals, jidx = jax.lax.top_k(jnp.asarray(x), 4)
    assert np.array_equal(to_np(idx), np.asarray(jidx))
    assert np.array_equal(to_np(vals), np.asarray(jvals))


@pytest.mark.parametrize("kind", ["uint8", "float32"])
def test_k1_plain_equals_pallas_interpret(kind):
    """K1's plain version = the Pallas kernel: detections exactly, raw on
    the 8-pixel interior."""
    img = _image(kind)
    with pltpu.force_tpu_interpret_mode():
        pdet, praw = fast_detect_pallas(jnp.asarray(img), 20.0, margin=19)
    det, raw = cuda_fast.fast_detect(t(img)[None], 20.0, margin=19)
    assert np.array_equal(to_np(det[0]), np.asarray(pdet))
    inner = (slice(8, -8), slice(8, -8))
    assert np.array_equal(to_np(raw[0])[inner], np.asarray(praw)[inner])


def test_k1_plain_detections_equal_wraparound_formulation():
    """margin >= 4 hides the zero taps vs circular roll difference."""
    img = t(_image("uint8"))[None]
    det, _ = cuda_fast.fast_detect_plain(img, 20.0, margin=4)
    ref = tfast._mask_border(tfast._nms(tfast.fast_score_map(img, 20.0), 1), 4)
    assert torch.equal(det, ref)


def test_k1_wrapper_uses_plain_version_only_for_cpu_tensors():
    before = cuda_fast.fast_detect.launches
    cuda_fast.fast_detect(torch.zeros((1, 40, 40), dtype=torch.uint8), 20.0, margin=19)
    assert cuda_fast.fast_detect.launches == before  # plain-version calls do not count
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_fast.fast_detect(torch.zeros((1, 40, 40), device="meta"), 20.0, margin=19)


def test_detect_keypoints_forced_kernel_path_equals_default_on_cpu():
    """use_pallas=True routes through K1's wrapper (its plain version on the
    CPU) and finds the same keypoints as the wrap-around formulation."""
    img = t(_image("uint8"))
    a = tfast.detect_keypoints(img, 64, tfast.FastConfig(grid_cells=8, use_pallas=True))
    b = tfast.detect_keypoints(img, 64, tfast.FastConfig(grid_cells=8, use_pallas=False))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_approx_select_is_rejected():
    with pytest.raises(ValueError, match="TPU-only"):
        tfast.detect_keypoints(
            t(_image("uint8")), 64, tfast.FastConfig(grid_cells=8, approx_select=True)
        )
