"""``tests/test_real_frames.py``'s checks through the port, on the committed
real frames of ``tests/data/real`` (sliding crops and homography-warped
views of a public-domain photograph), against the JAX package.

Integer stages are compared bit for bit: decode, FAST keypoints and scores,
BRIEF descriptors, match pairs. Each check of the reference's file is then
held on the port with the reference's own thresholds. Where RANSAC decides
(the E/H choice, the loop verifier, the pose), the port and the reference
are compared on the decision and each is held to ground truth, as
``tests/test_torch_slam.py`` does: near-tied hypotheses are picked by f32
rounding in either package (ROADMAP Queue 3).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_parity import desc_u32, t, to_np

from mvslam_tpu import native as jnative
from mvslam_tpu.frontend import pose_estimator as jpose
from mvslam_tpu.ops import detect as jdetect
from mvslam_tpu.ops import fast as jfast
from mvslam_tpu.ops import hamming as jhamming
from mvslam_tpu.ops import lk as jlk
from mvslam_tpu.ops.brief import BriefConfig as JBriefConfig
from mvslam_tpu.runtime import frame_stream as jfs
from mvslam_tpu_torch import native
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.frontend import pose_estimator as tpose
from mvslam_tpu_torch.geometry.epipolar import decompose_homography
from mvslam_tpu_torch.geometry.projection import normalize_pixels
from mvslam_tpu_torch.ops import detect as tdetect
from mvslam_tpu_torch.ops import fast as tfast
from mvslam_tpu_torch.ops import hamming as thamming
from mvslam_tpu_torch.ops import lk as tlk
from mvslam_tpu_torch.ops.brief import BriefConfig
from mvslam_tpu_torch.ops.ransac import RansacConfig, ransac_essential, ransac_homography
from mvslam_tpu_torch.runtime import frame_stream as tfs

DATA = Path(__file__).parent / "data" / "real"
FRAME_PATHS = sorted(DATA.glob("hopper_0*.png"))
ALL_PNGS = sorted(DATA.glob("*.png"))


def load_gray(path: Path) -> np.ndarray:
    with Image.open(path) as im:
        return np.asarray(im.convert("L"))


def _meta():
    return json.loads((DATA / "homographies.json").read_text())


def _rot_err_deg(R_est, R_gt):
    cos = (np.trace(np.asarray(R_est) @ np.asarray(R_gt).T) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))


@pytest.mark.parametrize("name", [p.name for p in ALL_PNGS])
def test_decode_equals_reference(name):
    """Every committed real frame: the port's C++ and numpy decoders and
    its default reader equal the reference's libpng decoder and Pillow."""
    path = DATA / name
    ref = jnative.decode_gray(path)
    assert ref is not None
    np.testing.assert_array_equal(ref, load_gray(path))
    np.testing.assert_array_equal(native.decode_gray(path), ref)
    np.testing.assert_array_equal(tfs.decode_png(path.read_bytes()), ref)
    np.testing.assert_array_equal(tfs._default_read_fn(path), jfs._default_read_fn(path))


def _features_both(img, num=512):
    """(port, reference) detect_and_describe of one grey frame, compared
    bit for bit."""
    ours = tdetect.detect_and_describe(t(img, torch.float32), num, tfast.FastConfig(), BriefConfig())
    ref = jdetect.detect_and_describe(jnp.asarray(img, jnp.float32), num, jfast.FastConfig(), JBriefConfig())
    (txy, tsc, tdesc, tang, tval), (jxy, jsc, jdesc, jang, jval) = ours, ref
    np.testing.assert_array_equal(to_np(tval), np.asarray(jval))
    np.testing.assert_array_equal(to_np(txy), np.asarray(jxy))
    np.testing.assert_array_equal(to_np(tsc), np.asarray(jsc))
    np.testing.assert_array_equal(desc_u32(tdesc), np.asarray(jdesc))
    np.testing.assert_array_equal(to_np(tang), np.asarray(jang))
    return ours, ref


def _matched_both(img_a, img_b, max_matches=256):
    """Features, cross-checked matches and matched points of a pair in both
    packages, the integer stages bit-equal; returns the port's (p1, p2,
    selection) and the reference's."""
    (ta, ja), (tb, jb) = _features_both(img_a), _features_both(img_b)
    tres = thamming.match_descriptors(ta[2], ta[4], tb[2], tb[4], thamming.MatchConfig(cross_check=True))
    jres = jhamming.match_descriptors(ja[2], ja[4], jb[2], jb[4], jhamming.MatchConfig(cross_check=True))
    tsel, jsel = thamming.select_matches(tres, max_matches), jhamming.select_matches(jres, max_matches)
    np.testing.assert_array_equal(to_np(tsel.pairs), np.asarray(jsel.pairs))
    np.testing.assert_array_equal(to_np(tsel.valid), np.asarray(jsel.valid))
    np.testing.assert_array_equal(to_np(tsel.distances), np.asarray(jsel.distances))
    tp1, tp2 = thamming.gather_matched_points(ta[0], tb[0], tsel)
    jp1, jp2 = jhamming.gather_matched_points(ja[0], jb[0], jsel)
    np.testing.assert_array_equal(to_np(tp1), np.asarray(jp1))
    np.testing.assert_array_equal(to_np(tp2), np.asarray(jp2))
    return (tp1, tp2, tsel), (jp1, jp2, jsel)


def test_fast_keypoints_on_real_texture_equal_reference():
    """FAST at the default threshold: the same keypoints and scores, a
    healthy count on the photograph, and a bounded one on the low-texture
    MRI slice."""
    for path, num, check in ((FRAME_PATHS[0], 512, lambda n: n > 150), (DATA / "mri_slice.png", 256, lambda n: n <= 256)):
        img = load_gray(path)
        txy, tsc, tval = tfast.detect_keypoints(t(img, torch.float32), num_keypoints=num, config=tfast.FastConfig())
        jxy, jsc, jval = jfast.detect_keypoints(jnp.asarray(img, jnp.float32), num_keypoints=num, config=jfast.FastConfig())
        np.testing.assert_array_equal(to_np(tval), np.asarray(jval))
        np.testing.assert_array_equal(to_np(txy), np.asarray(jxy))
        np.testing.assert_array_equal(to_np(tsc), np.asarray(jsc))
        assert check(int(tval.sum()))


@pytest.mark.parametrize("first", [0, 3, 6])
def test_matching_recovers_the_known_shift(first):
    """Consecutive sliding crops: descriptors and match pairs bit-equal to
    the reference; the port recovers the (-6, -2) px crop shift by the
    reference's thresholds."""
    (p1, p2, sel), _ = _matched_both(load_gray(FRAME_PATHS[first]), load_gray(FRAME_PATHS[first + 1]))
    valid = to_np(sel.valid)
    assert valid.sum() > 60, "too few cross-checked matches on real texture"
    disp = (to_np(p2) - to_np(p1))[valid]
    med = np.median(disp, axis=0)
    assert abs(med[0] + 6.0) < 0.75 and abs(med[1] + 2.0) < 0.75, med
    err = np.hypot(disp[:, 0] + 6.0, disp[:, 1] + 2.0)
    assert (err < 1.5).mean() > 0.7


def test_rotation_pair_h_branch_and_model_choice():
    """The camera-rotation pair: the port's H branch recovers the true R
    within 1 degree; its fused dual-model program makes the reference's
    E/H choice, with the planar support share and the true rotation."""
    meta = _meta()
    K = np.asarray(meta["K"], np.float32)
    R_gt = np.asarray(meta["rot"]["R"])
    (p1, p2, sel), (jp1, jp2, jsel) = _matched_both(load_gray(DATA / "hopper_rot_00.png"),
                                                  load_gray(DATA / "hopper_rot_01.png"))
    assert int(sel.valid.sum()) > 60
    n1, n2 = normalize_pixels(p1, t(K)), normalize_pixels(p2, t(K))
    res_h = ransac_homography(prng.key(5), n1, n2, sel.valid, RansacConfig(num_hypotheses=256, min_inliers=30),
                              threshold=3.0 / float(K[0, 0]))
    assert bool(res_h.success) and int(res_h.num_inliers) > 60
    R_h, _, _ = decompose_homography(res_h.model, n1, n2)
    assert _rot_err_deg(to_np(R_h), R_gt) < 1.0
    ours = tpose.estimate_pose_device(prng.key(5), p1, p2, sel.valid, t(K), tpose.RobustPoseEstimatorConfig(num_hypotheses=256))
    ref = jpose.estimate_pose_device(jax.random.key(5), jp1, jp2, jsel.valid, jnp.asarray(K),
                                     jpose.RobustPoseEstimatorConfig(num_hypotheses=256))
    assert bool(ours.use_essential) == bool(ref.use_essential)
    assert 0.4 < float(ours.homography_share) < 0.6, float(ours.homography_share)
    assert float(ours.median_parallax_deg) < 0.5
    assert _rot_err_deg(to_np(ours.rotation), R_gt) < 1.0
    assert _rot_err_deg(to_np(ours.rotation), np.asarray(ref.rotation)) < 0.1


def test_planar_exposure_pair_picks_h_as_the_reference():
    """Plane, translation and an exposure change: H wins in both packages
    with a healthy inlier set."""
    meta = _meta()
    K = np.asarray(meta["K"], np.float32)
    (p1, p2, sel), (jp1, jp2, jsel) = _matched_both(load_gray(DATA / "hopper_plane_00.png"),
                                                  load_gray(DATA / "hopper_plane_01.png"))
    assert int(sel.valid.sum()) > 60, "matching collapsed under exposure change"
    ours = tpose.estimate_pose_device(prng.key(6), p1, p2, sel.valid, t(K), tpose.RobustPoseEstimatorConfig(num_hypotheses=256))
    ref = jpose.estimate_pose_device(jax.random.key(6), jp1, jp2, jsel.valid, jnp.asarray(K),
                                     jpose.RobustPoseEstimatorConfig(num_hypotheses=256))
    assert not bool(ours.use_essential) and not bool(ref.use_essential)
    assert int(ours.num_inliers) >= 40 and float(ours.inlier_ratio) > 0.5
    assert abs(int(ours.num_inliers) - int(ref.num_inliers)) <= 2


def test_lk_tracks_rotational_flow_as_the_reference():
    """Pyramidal LK on the rotation pair: the port's tracks land where the
    true homography sends them (median < 1 px), and within 0.01 px of the
    reference's (iterated f32 solves on real texture differ by up to
    ~0.004 px; ``tests/test_torch_lk.py`` holds 1e-3 on its synthetic
    cases)."""
    H = np.asarray(_meta()["rot"]["H"])
    img_a = load_gray(DATA / "hopper_rot_00.png").astype(np.float32)
    img_b = load_gray(DATA / "hopper_rot_01.png").astype(np.float32)
    xy, _, valid = tfast.detect_keypoints(t(img_a), num_keypoints=256, config=tfast.FastConfig())
    jxy, _, jvalid = jfast.detect_keypoints(jnp.asarray(img_a), num_keypoints=256, config=jfast.FastConfig())
    np.testing.assert_array_equal(to_np(xy), np.asarray(jxy))
    nxt, residuals, ok = tlk.lk_track(t(img_a), t(img_b), xy, valid, tlk.LKConfig(num_levels=3))
    jnxt, jres, jok = jlk.lk_track(jnp.asarray(img_a), jnp.asarray(img_b), jxy, jvalid, jlk.LKConfig(num_levels=3))
    ok_np = to_np(ok & valid)
    assert ok_np.sum() > 80, f"LK lost too many tracks under rotation ({ok_np.sum()})"
    pts = to_np(xy)[ok_np]
    pred = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ H.T
    pred = pred[:, :2] / pred[:, 2:3]
    assert np.median(np.linalg.norm(to_np(nxt)[ok_np] - pred, axis=1)) < 1.0
    both = ok_np & np.asarray(jok & jvalid)
    assert both.sum() >= 0.95 * ok_np.sum()
    assert np.abs(to_np(nxt)[both] - np.asarray(jnxt)[both]).max() <= 1e-2


def test_loop_verifier_decision_equals_reference():
    """The offline pipeline's loop verification recipe (match, essential
    RANSAC) accepts the true revisit in both packages."""
    K = np.asarray(_meta()["K"], np.float32)
    (p1, p2, sel), (jp1, jp2, jsel) = _matched_both(load_gray(DATA / "hopper_plane_00.png"),
                                                  load_gray(DATA / "hopper_plane_01.png"))
    cfg = dict(num_hypotheses=256, min_inliers=30)
    ours = ransac_essential(prng.key(11), normalize_pixels(p1, t(K)), normalize_pixels(p2, t(K)), sel.valid,
                            RansacConfig(**cfg), threshold=2.0 / float(K[0, 0]))
    from mvslam_tpu.geometry.projection import normalize_pixels as jnormalize
    from mvslam_tpu.ops import ransac as jransac

    ref = jransac.ransac_essential(jax.random.key(11), jnormalize(jp1, jnp.asarray(K)), jnormalize(jp2, jnp.asarray(K)),
                                   jsel.valid, jransac.RansacConfig(**cfg), threshold=2.0 / float(K[0, 0]))
    assert bool(ours.success) == bool(ref.success) is True
    assert int(ours.num_inliers) >= 30


def test_slam_system_tracks_the_real_sequence(tmp_path):
    """``SLAMSystem`` over the 8 real frames in both packages (the
    reference's test configuration, all else default): the same
    per-frame gate outcomes, at least len - 3 frames tracked by the port,
    and its full run artifacts."""
    from mvslam_tpu.frontend.feature_pipeline import FeaturePipelineConfig as JFeatureConfig
    from mvslam_tpu.slam import api as japi
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.slam import api as tapi

    frames = [load_gray(p).astype(np.float32) for p in FRAME_PATHS]
    runs = {}
    for name, api, feature, pose, kw in (
        ("port", tapi, FeaturePipelineConfig, tpose.RobustPoseEstimatorConfig, {"device": "cpu"}),
        ("ref", japi, JFeatureConfig, jpose.RobustPoseEstimatorConfig, {}),
    ):
        system = api.SLAMSystem(api.SLAMSystemConfig(
            run_id="real_frames", output_root=str(tmp_path / name), seed=7, fx=300.0, fy=300.0, cx=160.0, cy=120.0,
            feature=feature(num_features=512, max_matches=256), pose=pose(num_hypotheses=128),
        ), **kw)
        system.run_sequence(frames)
        runs[name] = system
    ours, ref = runs["port"], runs["ref"]
    for a, b in zip(ref.diagnostics, ours.diagnostics):
        assert (b.pose_success, b.num_features, b.num_matches) == (a.pose_success, a.num_features, a.num_matches)
    tracked = sum(1 for d in ours.diagnostics if d.pose_success)
    assert tracked >= len(frames) - 3, f"only {tracked}/{len(frames)} real frames tracked"
    run_dir = Path(ours.finalize_run().run_dir)
    assert any((run_dir / "trajectories").glob("*.npz"))
