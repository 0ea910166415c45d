"""The port's bundle adjustment, single-model RANSAC, window adjuster and
``SLAMSystem`` with local BA against the JAX package's.

Tolerances, derived from float64 runs of the same problems (the port's
core in float64 is the yardstick): BA poses within 1e-4 of the reference
(translation in scene units, rotation entries), points within 2e-3 (depth
is the weakly observed direction: the reference itself is ~5e-4 from
float64 on these problems), costs within 1e-4 relative, and
``conditioning_tripped`` equal. RANSAC sample indices are bit-equal;
inlier sets equal on well-posed scenes. ``triangulate_points`` is float64
numpy in both and equal exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity  # noqa: F401  (one torch thread per worker)
from torch_parity import t, to_np

from mvslam_tpu.backend import bundle_adjustment as jba
from mvslam_tpu.backend.keyframes import Keyframe as JKeyframe
from mvslam_tpu.geometry import lie_np as jlnp
from mvslam_tpu.ops import ransac as jr
from mvslam_tpu_torch.backend import bundle_adjustment as tba
from mvslam_tpu_torch.backend.keyframes import Keyframe
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.ops import ransac as tr

from test_bundle_adjustment import synthetic_ba_problem


def _port_obs(obs):
    return [tba.Observation(o.pose_index, o.point_index, o.uv) for o in obs]


def _float64_run(poses, points, obs, K, config):
    """The port's core in float64 on the same padded problem."""
    budget = max(64, 1 << (len(obs) - 1).bit_length())
    pbudget = max(64, 1 << (len(points) - 1).bit_length())
    op = np.zeros(budget, np.int64)
    ox = np.zeros(budget, np.int64)
    uv = np.zeros((budget, 2))
    mask = np.zeros(budget, bool)
    for k, o in enumerate(obs):
        op[k], ox[k], uv[k], mask[k] = o.pose_index, o.point_index, o.uv, True
    pts = np.zeros((pbudget, 3))
    pts[: len(points)] = points
    W = len(poses)
    packed = tba._ba_core_packed(
        tba._pose_params(torch.as_tensor(poses, dtype=torch.float64)), t(pts), t(op), t(ox), t(uv), t(mask),
        t(K, torch.float64), config, W, tba.ba_tables(op, ox, mask, W, pbudget),
    )
    return to_np(packed)[4 : 4 + W * 16].reshape(W, 4, 4)


@pytest.mark.parametrize("seed,noise", [(0, 0.5), (1, 1.0), (2, 0.2)])
def test_run_bundle_adjustment_equals_reference(seed, noise):
    poses_true, poses_init, _, pts_init, obs, K = synthetic_ba_problem(seed=seed, noise_px=noise)
    cfg = dict(max_iterations=8)
    rj = jba.run_bundle_adjustment(poses_init, pts_init, obs, K, jba.BundleAdjustmentConfig(**cfg))
    rt = tba.run_bundle_adjustment(poses_init, pts_init, _port_obs(obs), K, tba.BundleAdjustmentConfig(**cfg), device="cpu")
    dj, dt = rj.diagnostics, rt.diagnostics
    assert dt.conditioning_tripped == dj.conditioning_tripped is False
    assert (dt.iterations, dt.converged) == (dj.iterations, dj.converged)
    assert dt.initial_cost == pytest.approx(dj.initial_cost, rel=1e-4)
    assert dt.final_cost == pytest.approx(dj.final_cost, rel=1e-4)
    assert dt.condition_number == pytest.approx(dj.condition_number, rel=1e-2)
    np.testing.assert_allclose(rt.poses, rj.poses, atol=1e-4)
    np.testing.assert_allclose(rt.points, rj.points, atol=2e-3)
    ref64 = _float64_run(poses_init, pts_init, obs, K, tba.BundleAdjustmentConfig(**cfg))
    assert np.abs(rt.poses - ref64).max() < 2 * np.abs(rj.poses - ref64).max() + 1e-5
    # Anchors: the first pose and the second's camera-frame translation.
    np.testing.assert_allclose(rt.poses[0], poses_init[0], atol=1e-6)
    np.testing.assert_allclose(np.linalg.inv(rt.poses[1])[:3, 3], np.linalg.inv(poses_init[1])[:3, 3], atol=1e-5)


def test_ill_conditioned_window_trips_alike():
    rng = np.random.default_rng(4)
    K = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])
    W, P = 3, 30
    points = np.stack([rng.uniform(-3e5, 3e5, P), rng.uniform(-2e5, 2e5, P), rng.uniform(2e6, 3e6, P)], axis=1)
    poses = np.stack([np.eye(4)] * W)
    poses[:, 0, 3] = 0.5 * np.arange(W)
    obs = []
    for w in range(W):
        T_cw = np.linalg.inv(poses[w])
        cam = points @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = (cam[:, :2] / cam[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
        obs += [jba.Observation(w, p, uv[p]) for p in range(P)]
    rj = jba.run_bundle_adjustment(poses, points, obs, K, jba.BundleAdjustmentConfig(max_iterations=4))
    rt = tba.run_bundle_adjustment(poses, points, _port_obs(obs), K, tba.BundleAdjustmentConfig(max_iterations=4), device="cpu")
    assert rt.diagnostics.conditioning_tripped and rj.diagnostics.conditioning_tripped
    assert rt.diagnostics.condition_number > 1e8
    np.testing.assert_array_equal(rt.poses, poses)
    empty = tba.run_bundle_adjustment(np.stack([np.eye(4)] * 3), np.zeros((0, 3)), [], np.eye(3), device="cpu")
    assert empty.diagnostics == tba.BundleAdjustmentDiagnostics(0.0, 0.0, 0, True, False, 1.0)


def test_triangulate_points_equal_exactly():
    poses_true, _, _, _, obs, K = synthetic_ba_problem(noise_px=0.3)
    uv1 = np.stack([o.uv for o in obs if o.pose_index == 0])
    uv2 = np.stack([o.uv for o in obs if o.pose_index == 3])
    np.testing.assert_array_equal(
        tba.triangulate_points(poses_true[0], poses_true[3], uv1, uv2, K),
        jba.triangulate_points(poses_true[0], poses_true[3], uv1, uv2, K),
    )


def _two_view(seed, n=160, outliers=0.2, planar=False):
    """Normalised correspondences of a well-posed two-view scene."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  np.full(n, 6.0) if planar else rng.uniform(4, 9, n)], axis=1)
    R = jlnp.so3_exp(np.asarray([0.02, -0.05, 0.01]))
    x2 = X @ R.T + [0.4, 0.05, 0.1]
    p1, p2 = X[:, :2] / X[:, 2:], x2[:, :2] / x2[:, 2:]
    p2 = p2 + rng.normal(scale=2e-4, size=p2.shape)
    bad = rng.random(n) < outliers
    p2[bad] += rng.uniform(-0.2, 0.2, size=(bad.sum(), 2))
    mask = np.ones(n, bool)
    mask[-7:] = False  # padded slots
    return p1.astype(np.float32), p2.astype(np.float32), mask


@pytest.mark.parametrize("model", ["essential", "homography"])
@pytest.mark.parametrize("seed", [0, 1])
def test_single_model_ransac_equals_reference(model, seed):
    p1, p2, mask = _two_view(seed, planar=model == "homography")
    key_j = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(3), 11), 12)
    key_t = prng.fold_in(prng.fold_in(prng.key(3), 11), 12)
    sample = 8 if model == "essential" else 4
    idx_j = np.asarray(jr._sample_indices(key_j, jnp.asarray(mask), 128, sample))
    np.testing.assert_array_equal(to_np(tr._sample_indices(key_t, t(mask), 128, sample)), idx_j)
    if model == "essential":
        cfg_j, cfg_t = jr.RansacConfig(num_hypotheses=128, min_inliers=8), tr.RansacConfig(num_hypotheses=128, min_inliers=8)
        rj = jr.ransac_essential(key_j, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), cfg_j, threshold=2e-3)
        rt = tr.ransac_essential(key_t, t(p1), t(p2), t(mask), cfg_t, threshold=2e-3)
    else:
        rj = jr.ransac_homography(key_j, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), threshold=5e-3)
        rt = tr.ransac_homography(key_t, t(p1), t(p2), t(mask), threshold=5e-3)
    assert bool(rt.success) == bool(rj.success) is True
    np.testing.assert_array_equal(to_np(rt.inliers), np.asarray(rj.inliers))
    assert int(rt.num_inliers) == int(rj.num_inliers)
    assert float(rt.inlier_ratio) == pytest.approx(float(rj.inlier_ratio), rel=1e-6)
    Ej, Et = np.asarray(rj.model), to_np(rt.model)
    assert min(np.abs(Et - Ej).max(), np.abs(Et + Ej).max()) < 1e-3 * np.abs(Ej).max()


def _keyframes(pkg_kf, n=96, frames=3, seed=0, perturb=True):
    """The reference tests' synthetic keyframes: a shared 3-D scene seen
    from poses 0.6 apart along x, shared descriptors, 0.3 px noise."""
    rng = np.random.default_rng(seed)
    pts3d = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(8, 16, n)], axis=1)
    desc = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    kfs, truth = [], []
    for w in range(frames):
        T = np.eye(4)
        T[0, 3] = 0.6 * w
        truth.append(T.copy())
        T_cw = np.linalg.inv(T)
        cam = pts3d @ T_cw[:3, :3].T + T_cw[:3, 3]
        uv = (cam[:, :2] / cam[:, 2:]) * [400, 400] + [160, 120] + rng.normal(scale=0.3, size=(n, 2))
        pose = T.copy()
        if perturb and w == frames - 1:
            pose[:3, 3] += rng.normal(scale=0.05, size=3)
        kfs.append(pkg_kf(frame_id=w, timestamp=0.1 * w, pose=pose, keypoints=uv.astype(np.float32),
                          descriptors=desc, valid=np.ones(n, bool)))
    return kfs, truth


K_SYN = np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]])


@pytest.mark.parametrize("frames", [3, 4])
def test_window_adjuster_equals_reference(frames):
    kj, truth = _keyframes(JKeyframe, frames=frames)
    kt, _ = _keyframes(Keyframe, frames=frames)
    aj, at = jba.WindowBundleAdjuster(K_SYN), tba.WindowBundleAdjuster(K_SYN, device="cpu")
    rj, rt = aj.refine_window(kj), at.refine_window(kt)
    assert set(at._pair_cache) == set(aj._pair_cache)
    for pair in aj._pair_cache:
        np.testing.assert_array_equal(at._pair_cache[pair], aj._pair_cache[pair])
    assert rt is not None and rj is not None
    assert at.last_diagnostics.conditioning_tripped == aj.last_diagnostics.conditioning_tripped is False
    assert at.last_diagnostics.final_cost == pytest.approx(aj.last_diagnostics.final_cost, rel=1e-4)
    for a, b in zip(kt, kj):
        np.testing.assert_allclose(a.pose, b.pose, atol=1e-4)
    moved = np.linalg.norm(kt[-1].pose[:3, 3] - truth[-1][:3, 3])
    assert moved <= np.linalg.norm(_keyframes(Keyframe, frames=frames)[0][-1].pose[:3, 3] - truth[-1][:3, 3]) + 1e-6


def test_window_adjuster_pair_cache_and_degenerate_window(monkeypatch):
    kfs, _ = _keyframes(Keyframe, frames=4, perturb=False)
    adjuster = tba.WindowBundleAdjuster(K_SYN, device="cpu")
    key = prng.key(0)
    adjuster.refine_window(kfs[:3], key=key)
    assert set(adjuster._pair_cache) == {(0, 1), (1, 2)}
    cached = adjuster._pair_cache[(0, 1)]
    adjuster.refine_window(kfs[1:], key=key)
    assert set(adjuster._pair_cache) == {(0, 1), (1, 2), (2, 3)}
    assert adjuster._pair_cache[(0, 1)] is cached
    assert adjuster.refine_window(kfs[:1]) is None
    monkeypatch.setattr(tba, "triangulate_points", lambda *a, **k: np.full((len(a[2]), 3), np.inf))
    assert tba.WindowBundleAdjuster(K_SYN, device="cpu").refine_window(kfs[:3]) is None


def _strip_frames(num=6, h=96, w=160, shift=4):
    """``test_slam_system_with_local_ba``'s scene: the top half of a
    textured strip slides at half the speed of the bottom half."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 30, size=(h, w + shift * num)).astype(np.float32)
    for _ in range(90):
        y, x, s = rng.integers(22, h - 28), rng.integers(22, base.shape[1] - 28), rng.integers(3, 7)
        base[y : y + s, x : x + s] = rng.uniform(140, 255)
    half = h // 2
    return [
        np.concatenate([base[:half, (i * shift) // 2 : (i * shift) // 2 + w], base[half:, i * shift : i * shift + w]])
        for i in range(num)
    ]


FLAGS = ("pose_success", "failure_reason", "is_keyframe", "num_features", "num_matches")


def _slam(pkg, frames, root, intrinsics, keyframe, feature=128, matches=64, hyp=64, **run):
    from mvslam_tpu.backend.keyframes import KeyframeConfig as JKC
    from mvslam_tpu.frontend.feature_pipeline import FeaturePipelineConfig as JFC
    from mvslam_tpu.frontend.pose_estimator import RobustPoseEstimatorConfig as JPC
    from mvslam_tpu.slam import api as japi
    from mvslam_tpu_torch.backend.keyframes import KeyframeConfig
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam import api as tapi

    ref = pkg == "ref"
    api, FC, PC, KC = (japi, JFC, JPC, JKC) if ref else (tapi, FeaturePipelineConfig, RobustPoseEstimatorConfig, KeyframeConfig)
    fx, fy, cx, cy = intrinsics
    cfg = api.SLAMSystemConfig(
        run_id=f"ba_{pkg}", output_root=root, seed=3, fx=fx, fy=fy, cx=cx, cy=cy,
        feature=FC(num_features=feature, max_matches=matches), pose=PC(num_hypotheses=hyp),
        keyframe=KC(**keyframe), enable_local_ba=True, enable_relocalization=False, persist_map_snapshot=False,
    )
    system = api.SLAMSystem(cfg) if ref else api.SLAMSystem(cfg, device="cpu")
    diags = system.run_sequence(frames, **run)
    return system, diags


def _ba_events(system):
    return [e for e in system.telemetry.events() if e.name == "local_ba"]


def test_slam_system_with_local_ba_on_the_reference_tests_scene(tmp_path):
    """The scene of ``test_slam_system_with_local_ba``: the local_ba event
    fires on every keyframe window in both packages, and the integer
    stages and gate outcomes are equal."""
    frames = _strip_frames()
    kw = dict(keyframe=dict(min_translation=0.05, window_size=3), intrinsics=(100.0, 100.0, 80.0, 48.0))
    sj, dj = _slam("ref", frames, tmp_path / "ref", **kw)
    st, dt = _slam("port", frames, tmp_path / "port", **kw)
    assert [[getattr(d, f) for f in FLAGS] for d in dt] == [[getattr(d, f) for f in FLAGS] for d in dj]
    assert sum(d.pose_success for d in dt) >= 4
    assert len(_ba_events(st)) == len(_ba_events(sj)) >= 1
    assert st.finalize_run().num_keyframes == sj.finalize_run().num_keyframes >= 3


def test_slam_system_with_local_ba_against_ground_truth(tmp_path):
    """A rendered 3-D scene, windowed and with the default keyframe window
    of 5: equal integer stages, local BA run on every new keyframe, at
    least one refinement accepted, and each trajectory within
    ``tests/test_accuracy.py``'s gate (RANSAC's near-tied E hypotheses make
    the two trajectories differ by more than a tight tolerance, ROADMAP
    Queue 3, so each is held to ground truth)."""
    from mvslam_tpu.data.synthetic import render_scene
    from mvslam_tpu.eval.trajectory import compute_ate

    frames, gt, intrinsics, _ = render_scene(num_frames=10, h=240, w=320, seed=1)
    kw = dict(keyframe={}, intrinsics=intrinsics, feature=256, matches=128, hyp=128, window=4, windows_per_dispatch=2)
    sj, dj = _slam("ref", frames, tmp_path / "ref", **kw)
    st, dt = _slam("port", frames, tmp_path / "port", **kw)
    assert [[getattr(d, f) for f in FLAGS] for d in dt] == [[getattr(d, f) for f in FLAGS] for d in dj]
    assert len(_ba_events(st)) == len(_ba_events(sj)) == sum(d.is_keyframe for d in dt) - 1
    assert st._local_ba.last_diagnostics is not None
    extent = np.linalg.norm(gt[-1] - gt[0])
    for system in (sj, st):
        est = np.stack(system.trajectory.poses)[:, :3, 3]
        assert np.isfinite(est).all()
        assert compute_ate(est, gt) < 0.08 * extent
        assert (np.diff(est, axis=0) @ np.array([1.0, 0.0, 0.2]) > 0).mean() > 0.7


def test_slam_system_still_refuses_relocalization_and_snapshots(tmp_path):
    """Relocalization and snapshots were refused until they were ported;
    now each flag is taken, alone or with the other, and BA stays on the
    system's device."""
    from mvslam_tpu_torch.slam import api as tapi

    for flag in ("enable_relocalization", "persist_map_snapshot"):
        cfg = tapi.SLAMSystemConfig(output_root=tmp_path, **{
            "enable_relocalization": False, "persist_map_snapshot": False, flag: True})
        system = tapi.SLAMSystem(cfg, device="cpu")
        assert getattr(system.config, flag) is True
    system = tapi.SLAMSystem(dataclasses.replace(cfg, persist_map_snapshot=False), device="cpu")
    assert isinstance(system._local_ba, tba.WindowBundleAdjuster) and system._local_ba.device == torch.device("cpu")
