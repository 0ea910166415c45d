"""The two accuracy scenes that no other port test renders, through the
port on the CPU, held to ``tests/test_accuracy.py``'s own assertions:

- the yawing arc (``TestRotationalAccuracy``): ATE under 10% of the extent,
  per-step relative rotation within 1.2 degrees on average, accumulated
  rotation within 0.6-1.4 of the truth; the per-frame gate outcomes,
  feature and match counts and the E/H model choice of every frame equal
  the reference's run (both packages take the order-pinned RANSAC forms
  at its 256 matches);
- the noisy arc with window BA (``TestLocalBAAccuracy``): BA on beats BA
  off.

``tests/test_torch_cuda.py::test_accuracy_scenes_on_the_card_pass_the_gate``
runs the same scenes on the card.
"""

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)

from mvslam_tpu.data.synthetic import render_scene as jrender_scene
from mvslam_tpu.frontend.feature_pipeline import FeaturePipelineConfig as JFeatureConfig
from mvslam_tpu.frontend.pose_estimator import RobustPoseEstimatorConfig as JPoseConfig
from mvslam_tpu.slam import api as japi
from mvslam_tpu_torch.backend.keyframes import KeyframeConfig
from mvslam_tpu_torch.data.synthetic import render_scene
from mvslam_tpu_torch.eval.trajectory import compute_additional_metrics
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
from mvslam_tpu_torch.slam import api as tapi


def yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _config(api, intrinsics, root, run_id, **kw):
    fx, fy, cx, cy = intrinsics
    feature, pose = (JFeatureConfig, JPoseConfig) if api is japi else (FeaturePipelineConfig, RobustPoseEstimatorConfig)
    return api.SLAMSystemConfig(
        run_id=run_id, output_root=root, seed=3, fx=fx, fy=fy, cx=cx, cy=cy,
        feature=feature(num_features=512, max_matches=256),
        pose=pose(num_hypotheses=256, adaptive_threshold=False, essential_threshold_px=2.0),
        **kw,
    )


def _angle_deg(M):
    return np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1)))


@pytest.fixture(scope="module")
def yaw_arc_runs(tmp_path_factory):
    """The yawing arc through the port and the reference (the scene is
    rendered by each package's renderer; they are bit-equal)."""
    def arc(i):
        return yaw_matrix(0.03 * i), np.array([0.25 * i, 0.0, 0.05 * i])

    frames, gt_pos, intr, gt_poses = render_scene(traj_fn=arc)
    jframes = jrender_scene(traj_fn=arc)[0]
    assert all(np.array_equal(a, b) for a, b in zip(frames, jframes))
    root = tmp_path_factory.mktemp("yaw_arc")
    port = tapi.SLAMSystem(_config(tapi, intr, root / "port", "rotational"), device="cpu")
    ref = japi.SLAMSystem(_config(japi, intr, root / "ref", "rotational"))
    return frames, gt_pos, gt_poses, (port, port.run_sequence(frames)), (ref, ref.run_sequence(frames))


def test_yaw_arc_meets_the_reference_assertions(yaw_arc_runs):
    frames, gt_pos, gt_poses, (system, diags), _ = yaw_arc_runs
    tracked = [d for d in diags[1:] if d.pose_success]
    assert len(tracked) >= len(frames) - 3, [(d.frame_id, d.failure_reason) for d in diags]
    est_poses = np.stack(system.trajectory.poses)
    metrics = compute_additional_metrics(est_poses[:, :3, 3], gt_pos)
    extent = np.linalg.norm(gt_pos[-1] - gt_pos[0])
    assert metrics["ATE_RMSE"] < 0.10 * extent, metrics
    errs = []
    for i in range(len(frames) - 1):
        rel_est = est_poses[i, :3, :3].T @ est_poses[i + 1, :3, :3]
        rel_gt = gt_poses[i, :3, :3].T @ gt_poses[i + 1, :3, :3]
        errs.append(_angle_deg(rel_est.T @ rel_gt))
    assert np.mean(errs) < 1.2, errs
    d_tot = est_poses[0, :3, :3].T @ est_poses[-1, :3, :3]
    gt_tot = gt_poses[0, :3, :3].T @ gt_poses[-1, :3, :3]
    assert 0.6 * _angle_deg(gt_tot) < _angle_deg(d_tot) < 1.4 * _angle_deg(gt_tot)


def test_yaw_arc_model_choice_equals_reference(yaw_arc_runs):
    _, _, _, (_, ours), (_, ref) = yaw_arc_runs
    assert len(ours) == len(ref)
    for a, b in zip(ref, ours):
        assert (b.pose_success, b.failure_reason, b.num_features, b.num_matches) == (
            a.pose_success, a.failure_reason, a.num_features, a.num_matches), a.frame_id
    pairs = [(a.model_type, b.model_type) for a, b in zip(ref[1:], ours[1:])]
    assert all(a == b for a, b in pairs), pairs


def test_noisy_arc_window_ba_reduces_ate(tmp_path):
    """Window BA (on by default) must beat the same run without it on the
    noisy arc, every frame a keyframe."""
    def arc(i):
        return yaw_matrix(0.02 * i), np.array([0.25 * i, 0.0, 0.05 * i])

    frames, gt_pos, intr, _ = render_scene(num_frames=14, traj_fn=arc, noise=5.0, seed=11)

    def run_ate(ba: bool) -> float:
        system = tapi.SLAMSystem(_config(tapi, intr, tmp_path, f"ba_{int(ba)}",
                                         keyframe=KeyframeConfig(min_translation=0.05), enable_local_ba=ba),
                                 device="cpu")
        system.run_sequence(frames)
        est = np.stack(system.trajectory.poses)[:, :3, 3]
        return compute_additional_metrics(est, gt_pos)["ATE_RMSE"]

    ate_off = run_ate(False)
    ate_on = run_ate(True)
    assert ate_on < ate_off, (ate_on, ate_off)
