"""The port's tracking step against the JAX reference, end to end.

Features and match pairs agree exactly; poses within tolerances: XLA:CPU
and torch sum in different orders (docs/KNOWN_ISSUES.md §3), so a
residual at the inlier threshold may flip one vote.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import desc_u32, sliding_frames, t, to_np

from mvslam_tpu.data.synthetic import render_scene
from mvslam_tpu.frontend import feature_pipeline as jfp
from mvslam_tpu.frontend import pose_estimator as jpose
from mvslam_tpu.ops import brief as jbrief
from mvslam_tpu.ops import fast as jfast
from mvslam_tpu.ops import hamming as jham
from mvslam_tpu.ops import ransac as jransac
from mvslam_tpu.slam import tracking as jtrack
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.frontend import feature_pipeline as tfp
from mvslam_tpu_torch.frontend import pose_estimator as tpose
from mvslam_tpu_torch.ops import brief as tbrief
from mvslam_tpu_torch.ops import fast as tfast
from mvslam_tpu_torch.ops import hamming as tham
from mvslam_tpu_torch.ops import ransac as transac
from mvslam_tpu_torch.slam import tracking as ttrack

REPO = Path(__file__).resolve().parents[1]
K = np.array([[200.0, 0.0, 96.0], [0.0, 200.0, 64.0], [0.0, 0.0, 1.0]], np.float32)
FC = dict(num_features=256, max_matches=128)
PC = dict(num_hypotheses=64)


@pytest.mark.parametrize(
    "ours,ref",
    [
        (tfast.FastConfig, jfast.FastConfig),
        (tbrief.BriefConfig, jbrief.BriefConfig),
        (tham.MatchConfig, jham.MatchConfig),
        (transac.RansacConfig, jransac.RansacConfig),
        (tfp.FeaturePipelineConfig, jfp.FeaturePipelineConfig),
        (tpose.RobustPoseEstimatorConfig, jpose.RobustPoseEstimatorConfig),
    ],
)
def test_configs_equal_reference(ours, ref):
    """Same field names, order and defaults; frozen."""
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == [
        (f.name, f.default) for f in dataclasses.fields(ref)
    ]
    assert ours.__dataclass_params__.frozen


def test_packed_layout_constants_equal_reference():
    assert ttrack._SCALAR_FIELDS == jtrack._SCALAR_FIELDS
    assert tpose.DevicePoseResult._fields == jpose.DevicePoseResult._fields
    assert ttrack.TrackResult._fields == jtrack.TrackResult._fields
    assert tfp.FeatureSet._fields == jfp.FeatureSet._fields


def test_import_leaves_jax_out():
    code = (
        "import sys; import mvslam_tpu_torch.slam.tracking, mvslam_tpu_torch.ops.cuda_fast, "
        "mvslam_tpu_torch.ops.cuda_patches; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mvslam_tpu.'))]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture(scope="module")
def runs():
    """The same 7-frame sequence (window 3, two windows) through both."""
    frames = sliding_frames(7)
    jfc, jpc = jfp.FeaturePipelineConfig(**FC), jpose.RobustPoseEstimatorConfig(**PC)
    jprev = jtrack.bootstrap_frame(jnp.asarray(frames[0]), jfc)
    jlast, jtr = jtrack.track_superwindow(
        jax.random.key(0), jprev, jnp.asarray(frames[1:]), jnp.asarray(K), jfc, jpc,
        window=3, start_index=jnp.asarray(1, jnp.int32),
    )
    tfc, tpc = tfp.FeaturePipelineConfig(**FC), tpose.RobustPoseEstimatorConfig(**PC)
    prev = ttrack.bootstrap_frame(t(frames[0]), tfc)
    last, tr = ttrack.track_superwindow(prng.key(0), prev, t(frames[1:]), t(K), tfc, tpc, window=3, start_index=1)
    return frames, (jprev, jlast, jtr), (prev, last, tr)


def test_bootstrap_features_equal_reference(runs):
    _, (jprev, _, _), (prev, _, _) = runs
    assert np.array_equal(to_np(prev.valid), np.asarray(jprev.valid))
    assert np.abs(to_np(prev.xy) - np.asarray(jprev.xy)).max() <= 1e-6
    assert np.array_equal(desc_u32(prev.descriptors), np.asarray(jprev.descriptors))


def test_superwindow_features_and_matches_equal_reference(runs):
    _, (_, jlast, jtr), (_, last, tr) = runs
    assert tr.scalars_packed.shape == (2, 3, 25)
    assert tr.features_packed.shape == (2, 3, FC["num_features"], 11)
    xy, desc, valid = ttrack.pull_features(tr)
    jxy, jdesc, jvalid = jtrack.pull_features(jtr)
    assert jvalid.sum() > 1000
    assert np.array_equal(valid, jvalid)
    assert np.abs(xy - jxy).max() <= 1e-6
    assert np.array_equal(desc, jdesc)
    assert np.array_equal(desc_u32(last.descriptors), np.asarray(jlast.descriptors))
    assert np.array_equal(to_np(tr.match_mask), np.asarray(jtr.match_mask))
    assert np.abs(to_np(tr.matched_p1) - np.asarray(jtr.matched_p1)).max() <= 1e-6
    assert np.abs(to_np(tr.matched_p2) - np.asarray(jtr.matched_p2)).max() <= 1e-6
    assert np.array_equal(to_np(tr.match_distances), np.asarray(jtr.match_distances))


def test_superwindow_poses_equal_reference(runs):
    _, (_, _, jtr), (_, _, tr) = runs
    s, js = ttrack.pull_scalars(tr), jtrack.pull_scalars(jtr)
    assert np.array_equal(s["num_matches"], js["num_matches"])
    assert (s["num_matches"] > 0).all()
    assert np.array_equal(s["num_features"], js["num_features"])
    assert np.array_equal(s["use_essential"], js["use_essential"])
    assert np.linalg.norm(s["rotation"] - js["rotation"], axis=(-2, -1)).max() < 1e-3
    assert np.abs(s["translation"] - js["translation"]).max() < 1e-2
    assert np.abs(s["num_inliers"] - js["num_inliers"]).max() <= 2
    assert np.array_equal(s["median_displacement_px"], js["median_displacement_px"])


def test_packed_buffers_read_by_reference_host_code(runs):
    """The reference's host-side unpacking reads the port's buffers."""
    _, _, (_, _, tr) = runs
    xy, desc, valid = jtrack.unpack_features(to_np(tr.features_packed))
    assert np.array_equal(desc, desc_u32(tr.features_packed[..., 3:11].contiguous().view(torch.int32)))
    assert np.array_equal(valid, to_np(tr.features_packed[..., 2] > 0.5))
    assert np.array_equal(xy, to_np(tr.features_packed[..., :2]))
    scal = jtrack.pull_scalars(jtrack.TrackResult(*([None] * 7), scalars_packed=to_np(tr.scalars_packed), features_packed=None))
    ours = ttrack.pull_scalars(tr)
    for k, v in ours.items():
        assert np.array_equal(v, scal[k]), k


def test_track_frame_equals_reference(runs):
    frames, (jprev, _, _), (prev, _, _) = runs
    jfc, jpc = jfp.FeaturePipelineConfig(**FC), jpose.RobustPoseEstimatorConfig(**PC)
    jfeat, jtr = jtrack.track_frame(jax.random.key(5), jprev, jnp.asarray(frames[1]), jnp.asarray(K), jfc, jpc)
    feat, tr = ttrack.track_frame(
        prng.key(5), prev, t(frames[1]), t(K), tfp.FeaturePipelineConfig(**FC), tpose.RobustPoseEstimatorConfig(**PC)
    )
    assert np.array_equal(desc_u32(feat.descriptors), np.asarray(jfeat.descriptors))
    assert int(tr.num_matches) == int(jtr.num_matches) > 0
    assert bool(tr.pose.use_essential) == bool(jtr.pose.use_essential)
    assert np.linalg.norm(to_np(tr.pose.rotation) - np.asarray(jtr.pose.rotation)) < 1e-3
    assert abs(int(tr.pose.num_inliers) - int(jtr.pose.num_inliers)) <= 2


def test_window_equals_frame_by_frame(runs):
    """Per-pair keys fold the global frame id: a window of 3 equals three
    single-frame steps keyed with fold_in(key, id)."""
    frames, _, (prev, _, tr) = runs
    fc, pc = tfp.FeaturePipelineConfig(**FC), tpose.RobustPoseEstimatorConfig(**PC)
    for i in range(3):
        feat, single = ttrack.track_frame(
            prng.fold_in(prng.key(0), 1 + i), prev, t(frames[1 + i]), t(K), fc, pc
        )
        assert torch.equal(single.features_packed.view(torch.int32), tr.features_packed[0, i].view(torch.int32))
        assert torch.equal(single.pose.inliers, tr.pose.inliers[0, i])
        assert torch.allclose(single.scalars_packed, tr.scalars_packed[0, i], atol=1e-5)
        prev = feat


def test_superwindow_rejects_ragged_input():
    fc = tfp.FeaturePipelineConfig(**FC)
    prev = ttrack.bootstrap_frame(torch.zeros((64, 96), dtype=torch.uint8), fc)
    with pytest.raises(ValueError, match="multiple of window"):
        ttrack.track_superwindow(
            prng.key(0), prev, torch.zeros((5, 64, 96), dtype=torch.uint8), t(K), fc,
            tpose.RobustPoseEstimatorConfig(**PC), window=3,
        )


@pytest.fixture(scope="module", params=["scene", "planar"])
def rendered_runs(request):
    """track_superwindow over 9 rendered frames (240x320, 512 features) of a
    3-D scene and of a planar one, in both packages."""
    frames, _, (fx, fy, cx, cy), _ = render_scene(num_frames=9, h=240, w=320, seed=0, planar=request.param == "planar")
    frames = np.stack(frames)
    k = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32)
    fc, pc = dict(num_features=512, max_matches=256), dict(num_hypotheses=128)
    jfc, jpc = jfp.FeaturePipelineConfig(**fc), jpose.RobustPoseEstimatorConfig(**pc)
    jprev = jtrack.bootstrap_frame(jnp.asarray(frames[0]), jfc)
    _, jtr = jtrack.track_superwindow(
        jax.random.key(0), jprev, jnp.asarray(frames[1:]), jnp.asarray(k), jfc, jpc,
        window=4, start_index=jnp.asarray(1, jnp.int32),
    )
    tfc, tpc = tfp.FeaturePipelineConfig(**fc), tpose.RobustPoseEstimatorConfig(**pc)
    prev = ttrack.bootstrap_frame(t(frames[0]), tfc)
    _, tr = ttrack.track_superwindow(prng.key(0), prev, t(frames[1:]), t(k), tfc, tpc, window=4, start_index=1)
    return request.param, jtrack.pull_scalars(jtr), ttrack.pull_scalars(tr)


def test_model_selection_on_rendered_scenes(rendered_runs):
    """The E/H decision agrees on every pair of a 3-D and of a planar scene.
    ``homography_share`` agrees within one support vote wherever both
    packages end RANSAC on the same two models (scores within 1%): where the
    best E hypotheses are near-tied, f32 rounding in the 8-point null vector
    picks the winner in either package, and the share follows the model."""
    name, js, s = rendered_runs
    assert (js["num_matches"] > 200).all()
    assert np.array_equal(s["use_essential"], js["use_essential"])
    if name == "planar":
        assert not js["use_essential"].any()
    else:
        assert js["use_essential"].any() and not js["use_essential"].all()

    def close(key):
        return np.abs(s[key] - js[key]) <= 0.01 * np.abs(js[key])

    same_models = close("essential_score") & close("homography_score")
    # One support vote moves the share by 2 / (s_h + s_e) >= 1 / (2 n).
    one_vote = 1.0 / (2.0 * js["num_valid_matches"])
    share_err = np.abs(s["homography_share"] - js["homography_share"])
    assert (share_err[same_models] <= one_vote[same_models]).all(), (share_err, same_models)
    assert same_models.sum() >= 2, same_models  # the check is not vacuous


def test_pull_features_copies_each_buffer_once(runs, monkeypatch):
    """Every keyframe of a dispatch reads one host copy of its buffer: two
    providers on one TrackResult make one device-to-host copy, and the
    cache entry holds its buffer."""
    _, _, (_, _, tr) = runs
    copies = []
    real = ttrack.unpack_features
    monkeypatch.setattr(ttrack, "unpack_features", lambda packed: copies.append(1) or real(packed))
    monkeypatch.setattr(ttrack, "_FEATURE_FETCH_CACHE", type(ttrack._FEATURE_FETCH_CACHE)())
    providers = [lambda i=i: ttrack.pull_features(tr)[1][i] for i in range(2)]
    first, second = (p() for p in providers)
    assert len(copies) == 1
    assert np.array_equal(first, jtrack.unpack_features(to_np(tr.features_packed))[1][0])
    entry = ttrack._FEATURE_FETCH_CACHE[id(tr.features_packed)]
    assert entry[0] is tr.features_packed
    # A stale entry under the same id (a freed buffer's id reused) is replaced.
    other = tr.features_packed.clone()
    ttrack._FEATURE_FETCH_CACHE[id(tr.features_packed)] = (other, "stale")
    assert ttrack.pull_features(tr)[0].shape == tr.features_packed.shape[:-1] + (2,)
    assert len(copies) == 2 and ttrack._FEATURE_FETCH_CACHE[id(tr.features_packed)][0] is tr.features_packed
    # The cache holds at most its capacity of buffers, least recent out first.
    for _ in range(ttrack._FEATURE_FETCH_CACHE_CAP + 2):
        ttrack.pull_features(tr._replace(features_packed=tr.features_packed.clone()))
    assert len(ttrack._FEATURE_FETCH_CACHE) == ttrack._FEATURE_FETCH_CACHE_CAP
    assert id(tr.features_packed) not in ttrack._FEATURE_FETCH_CACHE


def test_feature_set_from_arrays_round_trips_reference_words(runs):
    """The reference's uint32 words become the port's int32 words, bit for bit."""
    _, (jprev, _, _), (prev, _, _) = runs
    fs = ttrack.feature_set_from_arrays(np.asarray(jprev.xy), np.asarray(jprev.descriptors), np.asarray(jprev.valid))
    assert fs.descriptors.dtype == torch.int32
    assert torch.equal(fs.descriptors, prev.descriptors)
    assert torch.equal(fs.valid, prev.valid) and torch.equal(fs.xy, prev.xy)


def test_match_and_estimate_equals_reference(runs):
    """The flow path's fallback: matching two given feature sets, the same
    match pairs and pose as the reference's."""
    frames, (jprev, _, _), (prev, _, _) = runs
    jfc, jpc = jfp.FeaturePipelineConfig(**FC), jpose.RobustPoseEstimatorConfig(**PC)
    fc, pc = tfp.FeaturePipelineConfig(**FC), tpose.RobustPoseEstimatorConfig(**PC)
    jcur = jtrack.bootstrap_frame(jnp.asarray(frames[2]), jfc)
    jtr = jtrack.match_and_estimate(jax.random.key(4), jprev, jcur, jnp.asarray(K), jfc, jpc)
    cur = ttrack.feature_set_from_arrays(np.asarray(jcur.xy), np.asarray(jcur.descriptors), np.asarray(jcur.valid))
    tr = ttrack.match_and_estimate(prng.key(4), prev, cur, t(K), fc, pc)
    assert np.array_equal(to_np(tr.match_mask), np.asarray(jtr.match_mask))
    assert np.abs(to_np(tr.matched_p2) - np.asarray(jtr.matched_p2)).max() <= 1e-6
    s, js = ttrack.pull_scalars(tr), jtrack.pull_scalars(jtr)
    assert s["num_matches"] == js["num_matches"] > 0 and s["use_essential"] == js["use_essential"]
    assert abs(s["num_inliers"] - js["num_inliers"]) <= 2
    assert np.linalg.norm(s["rotation"] - js["rotation"]) < 1e-3


def test_track_frame_flow_equals_reference(runs):
    """Flow-first step: the same features, LK tracks within 1e-3 px, the
    same valid tracks, and the pose of those tracks."""
    frames, (jprev, _, _), (prev, _, _) = runs
    jfc, jpc = jfp.FeaturePipelineConfig(**FC), jpose.RobustPoseEstimatorConfig(**PC)
    fc, pc = tfp.FeaturePipelineConfig(**FC), tpose.RobustPoseEstimatorConfig(**PC)
    jgray = jtrack.frame_to_gray(jnp.asarray(frames[0]))
    gray = ttrack.frame_to_gray(t(frames[0]))
    assert np.array_equal(to_np(gray), np.asarray(jgray))
    jg, jfeat, jtr = jtrack.track_frame_flow(jax.random.key(2), jgray, jprev, jnp.asarray(frames[1]), jnp.asarray(K), jfc, jpc)
    g, feat, tr = ttrack.track_frame_flow(prng.key(2), gray, prev, t(frames[1]), t(K), fc, pc)
    assert np.array_equal(to_np(g), np.asarray(jg))
    assert np.array_equal(desc_u32(feat.descriptors), np.asarray(jfeat.descriptors))
    assert np.array_equal(to_np(tr.match_mask), np.asarray(jtr.match_mask))
    assert np.abs(to_np(tr.matched_p2) - np.asarray(jtr.matched_p2)).max() <= 1e-3
    s, js = ttrack.pull_scalars(tr), jtrack.pull_scalars(jtr)
    assert s["num_matches"] == js["num_matches"] >= 100
    assert s["num_features"] == js["num_features"]
    assert s["use_essential"] == js["use_essential"]
    assert abs(s["num_inliers"] - js["num_inliers"]) <= 2
    assert np.linalg.norm(s["rotation"] - js["rotation"]) < 1e-3
    assert np.abs(s["median_displacement_px"] - js["median_displacement_px"]) < 1e-3
    assert torch.equal(tr.features_packed.view(torch.int32), ttrack._pack_features(feat).view(torch.int32))
