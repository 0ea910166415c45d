"""The port's front-end facades against the JAX package's.

``FeaturePipeline`` (single and batched detect+describe, bit-equal; match
and match statistics, equal), ``matches_to_points`` and
``adaptive_ransac_threshold`` (1e-6 relative), ``RobustPoseEstimator``
(the same success or failure reason and model type; poses within
``test_torch_tracking.py``'s tolerances), and ``frontend/intrinsics.py``
(focal estimates within 1e-4 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import desc_u32, t, to_np

import mvslam_tpu.frontend as jfront
from mvslam_tpu.data.synthetic import render_scene
from mvslam_tpu.frontend import feature_pipeline as jfp
from mvslam_tpu.frontend import intrinsics as jintr
from mvslam_tpu.frontend import pose_estimator as jpose
import mvslam_tpu_torch.frontend as tfront
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.frontend import feature_pipeline as tfp
from mvslam_tpu_torch.frontend import intrinsics as tintr
from mvslam_tpu_torch.frontend import pose_estimator as tpose

FC = dict(num_features=128, max_matches=64)


def _frames(n=4, seed=0, h=96, w=128):
    """``tests/test_runtime.py``'s plane frames (float32)."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n):
        img = rng.uniform(0, 30, size=(h, w)).astype(np.float32)
        for _ in range(40):
            y, x, s = rng.integers(22, h - 28), rng.integers(22, w - 28), rng.integers(3, 7)
            img[y : y + s, x : x + s] = rng.uniform(140, 255)
        frames.append(img)
    return np.stack(frames)


def test_public_names_equal_reference():
    assert tfront.__all__ == jfront.__all__
    for name in tfront.__all__:
        assert hasattr(tfront, name)
    for ours, ref in ((tfp.MatchStats, jfp.MatchStats), (tpose.PoseEstimate, jpose.PoseEstimate)):
        assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    assert tintr.__all__ == jintr.__all__


def test_pipeline_runs_on_the_card_unless_asked():
    assert tfp.FeaturePipeline().device == torch.device("cuda")
    assert tfp.build_feature_pipeline(device="cpu").device == torch.device("cpu")
    assert tpose.RobustPoseEstimator().device == torch.device("cuda")
    assert tpose.RobustPoseEstimator(device="cpu").device == torch.device("cpu")
    # Arrays go to the card by default: on a machine without one that fails.
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tfp.adaptive_ransac_threshold(1.5, np.zeros((4, 2), np.float32), np.ones((4, 2), np.float32))


@pytest.fixture(scope="module", params=["float32", "uint8"])
def extracted(request):
    frames = _frames()
    if request.param == "uint8":
        frames = frames.astype(np.uint8)
    ours = tfp.FeaturePipeline(tfp.FeaturePipelineConfig(**FC), device="cpu")
    ref = jfp.FeaturePipeline(jfp.FeaturePipelineConfig(**FC))
    return frames, ours, ref, ours.detect_and_describe_batch(frames), ref.detect_and_describe_batch(jnp.asarray(frames))


def _assert_features_equal(ours, ref):
    assert np.array_equal(to_np(ours.valid), np.asarray(ref.valid))
    assert np.array_equal(to_np(ours.xy), np.asarray(ref.xy))
    assert np.array_equal(to_np(ours.scores), np.asarray(ref.scores))
    assert np.array_equal(desc_u32(ours.descriptors), np.asarray(ref.descriptors))


def test_detect_and_describe_batch_equals_reference(extracted):
    _, _, _, ours, ref = extracted
    assert ours.xy.shape == (4, FC["num_features"], 2) and ours.descriptors.dtype == torch.int32
    assert int(ours.valid.sum()) > 100
    _assert_features_equal(ours, ref)


def test_detect_and_describe_equals_reference_and_the_batch(extracted):
    frames, pipeline, ref_pipeline, batch, _ = extracted
    for i in (0, 3):
        ours = pipeline.detect_and_describe(frames[i])
        _assert_features_equal(ours, ref_pipeline.detect_and_describe(jnp.asarray(frames[i])))
        assert all(torch.equal(a, b[i]) for a, b in zip(ours, batch))
    assert ours.num_valid == int(batch.valid[3].sum())


def test_match_and_stats_equal_reference(extracted):
    _, pipeline, ref_pipeline, ours, ref = extracted
    pick = lambda fs, i: type(fs)(*(a[i] for a in fs))  # noqa: E731
    for i, j in ((0, 1), (1, 3)):
        sel = pipeline.match(pick(ours, i), pick(ours, j))
        jsel = ref_pipeline.match(pick(ref, i), pick(ref, j))
        assert np.array_equal(to_np(sel.pairs), np.asarray(jsel.pairs))
        assert np.array_equal(to_np(sel.valid), np.asarray(jsel.valid))
        assert np.array_equal(to_np(sel.distances), np.asarray(jsel.distances))
        stats = pipeline.match_stats(pick(ours, i), pick(ours, j), sel)
        assert dataclasses.asdict(stats) == dataclasses.asdict(ref_pipeline.match_stats(pick(ref, i), pick(ref, j), jsel))
        assert stats.num_matches > 10
        p1, p2, mask = tfp.matches_to_points(pick(ours, i), pick(ours, j), sel)
        jp1, jp2, jmask = jfp.matches_to_points(pick(ref, i), pick(ref, j), jsel)
        assert np.array_equal(to_np(p1), np.asarray(jp1)) and np.array_equal(to_np(p2), np.asarray(jp2))
        assert np.array_equal(to_np(mask), np.asarray(jmask))


@pytest.mark.parametrize("case", ["small_motion", "large_motion", "masked", "no_mask", "all_masked"])
def test_adaptive_ransac_threshold_equals_reference(case):
    rng = np.random.default_rng(3)
    p1 = rng.uniform(0, 200, size=(57, 2)).astype(np.float32)
    shift = {"small_motion": 3.0, "large_motion": 90.0}.get(case, 20.0)
    p2 = (p1 + shift + rng.normal(0, 2.0, size=p1.shape)).astype(np.float32)
    mask = {"masked": rng.random(57) < 0.5, "all_masked": np.zeros(57, bool), "no_mask": None}.get(case, np.ones(57, bool))
    ours = tfp.adaptive_ransac_threshold(1.5, p1, p2, mask, device="cpu")
    ref = jfp.adaptive_ransac_threshold(1.5, p1, p2, mask)
    assert isinstance(ours, float)
    assert ours == pytest.approx(ref, rel=1e-6)
    assert tfp.adaptive_ransac_threshold(1.5, t(p1), t(p2), None if mask is None else t(mask), device="cpu") == ours


# ----------------------------------------------------------------------
# RobustPoseEstimator on rendered pairs
# ----------------------------------------------------------------------


@pytest.fixture(scope="module", params=["scene", "planar"])
def rendered_pairs(request):
    """Matched pixel points of consecutive rendered frames (240x320, 512
    features: ``test_torch_tracking.py``'s scenes), from the reference's
    pipeline, so both estimators see the same points."""
    frames, _, (fx, fy, cx, cy), _ = render_scene(num_frames=4, h=240, w=320, seed=0, planar=request.param == "planar")
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32)
    pipeline = jfp.FeaturePipeline(jfp.FeaturePipelineConfig(num_features=512, max_matches=256))
    feats = [pipeline.detect_and_describe(jnp.asarray(f)) for f in frames]
    pairs = []
    for a, b in zip(feats[:-1], feats[1:]):
        p1, p2, mask = jfp.matches_to_points(a, b, pipeline.match(a, b))
        pairs.append((np.asarray(p1), np.asarray(p2), np.asarray(mask)))
    return request.param, K, pairs


def _estimate_both(K, p1, p2, mask, seed):
    cfg = dict(num_hypotheses=128)
    out = []
    for est, key in (
        (tpose.RobustPoseEstimator(tpose.RobustPoseEstimatorConfig(**cfg), device="cpu"), prng.key(seed)),
        (jpose.RobustPoseEstimator(jpose.RobustPoseEstimatorConfig(**cfg)), jax.random.key(seed)),
    ):
        try:
            out.append(est.estimate_pose(p1, p2, mask, K, key))
        except (tpose.PoseEstimationFailure, jpose.PoseEstimationFailure) as failure:
            out.append(failure.reason)
    return out


def test_estimate_pose_equals_reference(rendered_pairs):
    name, K, pairs = rendered_pairs
    for i, (p1, p2, mask) in enumerate(pairs):
        ours, ref = _estimate_both(K, p1, p2, mask, seed=i)
        assert isinstance(ours, tpose.PoseEstimate) and isinstance(ref, jpose.PoseEstimate), (ours, ref)
        assert ours.model_type == ref.model_type
        if name == "planar":
            assert ours.model_type == "homography"
        assert np.linalg.norm(ours.rotation - np.asarray(ref.rotation)) < 1e-3
        assert np.abs(ours.translation - np.asarray(ref.translation)).max() < 1e-2
        assert abs(ours.num_inliers - ref.num_inliers) <= 2
        assert ours.inlier_mask.shape == np.asarray(ref.inlier_mask).shape
        assert abs(float(np.linalg.norm(ours.translation)) - 1.0) < 1e-5


@pytest.mark.parametrize("failure", ["insufficient_matches", "insufficient_motion"])
def test_estimate_pose_fails_as_the_reference(rendered_pairs, failure):
    _, K, pairs = rendered_pairs
    p1, p2, mask = pairs[0]
    if failure == "insufficient_matches":
        mask = mask & (np.cumsum(mask) <= 8)
    else:
        p2 = p1 + np.float32(0.25)
    ours, ref = _estimate_both(K, p1, p2, mask, seed=0)
    assert ours == ref == failure


# ----------------------------------------------------------------------
# intrinsics
# ----------------------------------------------------------------------


def _line_families(f=420.0, c=(160.0, 120.0), seed=0):
    """Image segments of two orthogonal families of parallel 3-D lines seen
    by a rotated camera with focal ``f``."""
    rng = np.random.default_rng(seed)
    a, b = np.radians(25.0), np.radians(-15.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]) @ np.array(
        [[1, 0, 0], [0, np.cos(b), -np.sin(b)], [0, np.sin(b), np.cos(b)]]
    )

    def project(X):
        x = (R @ X.T).T
        return np.stack([f * x[:, 0] / x[:, 2] + c[0], f * x[:, 1] / x[:, 2] + c[1]], axis=-1)

    families = []
    for d in (np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 1.0])):
        segs = []
        for _ in range(5):
            p = rng.uniform([-2, -1, 6], [2, 1, 9])
            ends = project(np.stack([p, p + 1.5 * d]))
            segs.append((ends[0], ends[1]))
        families.append(segs)
    return families, np.asarray(c)


def test_lines_and_intersections_equal_reference():
    rng = np.random.default_rng(1)
    p1, p2 = rng.uniform(0, 300, size=(2, 6, 2)).astype(np.float32)
    lines = tintr.line_through_points(t(p1), t(p2))
    ref = np.asarray(jintr.line_through_points(jnp.asarray(p1), jnp.asarray(p2)))
    np.testing.assert_allclose(to_np(lines), ref, rtol=1e-6)
    x = tintr.intersect_lines(lines[:3], lines[3:])
    np.testing.assert_allclose(to_np(x), np.asarray(jintr.intersect_lines(jnp.asarray(ref[:3]), jnp.asarray(ref[3:]))), rtol=1e-5)


def test_focal_from_line_pairs_equals_reference():
    (fam_a, fam_b), c = _line_families()
    ours = tintr.estimate_focal_from_line_pairs(fam_a, fam_b, c)
    ref = jintr.estimate_focal_from_line_pairs(fam_a, fam_b, c)
    assert ours == pytest.approx(ref, rel=1e-4)
    assert ours == pytest.approx(420.0, rel=1e-2)
    va, vb = np.array([900.0, 130.0]), np.array([-300.0, 110.0])
    assert tintr.estimate_focal_from_vanishing_points(va, vb, c) == jintr.estimate_focal_from_vanishing_points(va, vb, c)
    # Degenerate: one segment in a family, or vanishing points on one side of c.
    assert tintr.estimate_focal_from_line_pairs(fam_a[:1], fam_b, c) is None
    assert jintr.estimate_focal_from_line_pairs(fam_a[:1], fam_b, c) is None
    assert tintr.estimate_focal_from_vanishing_points(va, va, c) is None


def test_make_k_helpers_equal_reference(tmp_path):
    assert np.allclose(to_np(tintr.make_K_from_fov(640, 480, 70.0)), np.asarray(jintr.make_K_from_fov(640, 480, 70.0)))
    path = tmp_path / "K.txt"
    path.write_text("718.8 718.8 607.2 185.2\n")
    assert np.array_equal(tintr.load_K_from_file(path), jintr.load_K_from_file(path))
