"""The port's ``run_visual_slam`` on ``tests/test_accuracy.py``'s loop-closure
scene (29 frames, 320x240, out 14 frames and back), three whole runs on the
CPU: with loop closure, the same again, and without.

The port is held to ground truth and to itself, not to the JAX package's
trajectory (RANSAC's essential model is set by f32 rounding where
hypotheses nearly tie, ROADMAP Queue 3; the reference's own run of this
scene is ``tests/test_accuracy.py::TestLoopClosureAccuracy``). The three
runs take about two minutes on one thread, so they have a file, and with
it a worker, of their own.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)

from mvslam_tpu_torch.data.synthetic import render_scene, write_kitti_sequence
from mvslam_tpu_torch.loopclosure.persistent_map import load_map_snapshot
from mvslam_tpu_torch.slam import offline as toffline

HALF = 14


def _out_and_back(i):
    x = 0.25 * i if i <= HALF else 0.25 * (2 * HALF - i)
    return np.eye(3), np.array([x, 0.0, 0.0])


@pytest.fixture(scope="module")
def revisit(tmp_path_factory):
    frames, gt_pos, intrinsics, _ = render_scene(num_frames=2 * HALF + 1, traj_fn=_out_and_back, noise=6.0, seed=2)
    root, gt_path = write_kitti_sequence(tmp_path_factory.mktemp("revisit") / "kitti", frames, gt_pos, intrinsics)
    return SimpleNamespace(root=root, gt_path=gt_path)


@pytest.fixture(scope="module")
def offline_runs(revisit, tmp_path_factory):
    out = tmp_path_factory.mktemp("offline_runs")
    common = dict(
        input_path=revisit.root, input_kind="kitti", sequence="00", seed=3, ground_truth_path=revisit.gt_path,
        loop_min_frame_gap=12, loop_similarity_threshold=0.7, loop_min_inliers=25,
    )
    runs = {}
    for name, loops in (("on", True), ("on_again", True), ("off", False)):
        cfg = toffline.SLAMRunConfig(run_id="loop", output_root=out / name, enable_loop_closure=loops, **common)
        runs[name] = toffline.run_visual_slam(cfg, device="cpu")
    return runs


def test_run_visual_slam_closes_loops_and_cuts_ate(offline_runs):
    on, off = offline_runs["on"], offline_runs["off"]
    assert on["frames"] == off["frames"] == 29 and on["failures"] == 0
    assert len(on["loops_accepted"]) >= 1 and off["loops_accepted"] == []
    assert on["metrics"]["ATE_RMSE"] < off["metrics"]["ATE_RMSE"], (on["metrics"], off["metrics"])
    extent = 0.25 * HALF
    assert on["metrics"]["ATE_RMSE"] < 0.05 * extent
    for loop in on["loops_accepted"]:
        assert loop["query"] - loop["candidate"] >= 12 and loop["inliers"] >= 25 and loop["inlier_ratio"] >= 0.4
        # a true revisit: frame q shows the place of frame 28 − q
        assert abs((2 * HALF - loop["query"]) - loop["candidate"]) <= 3


def test_run_visual_slam_twice_is_bit_equal(offline_runs):
    a, b = Path(offline_runs["on"]["run_dir"]), Path(offline_runs["on_again"]["run_dir"])
    assert (a / "offline_summary.json").read_bytes() == (b / "offline_summary.json").read_bytes()
    assert "run_dir" not in json.loads((a / "offline_summary.json").read_text())
    ta, tb = np.load(a / "trajectories" / "estimated.npz"), np.load(b / "trajectories" / "estimated.npz")
    assert sorted(ta.files) == sorted(tb.files) and all(np.array_equal(ta[k], tb[k]) for k in ta.files)


def test_run_visual_slam_persists_the_map_and_the_references_artifacts(offline_runs):
    run = Path(offline_runs["on"]["run_dir"])
    snapshot = load_map_snapshot(run / "maps" / "map_snapshot_arrays.npz", run / "maps" / "map_snapshot_metadata.json")
    assert len(snapshot.keyframes) == offline_runs["on"]["keyframes"] >= 20
    names = {e["name"] for e in json.loads((run / "telemetry" / "events.json").read_text())}
    assert {"track_window", "local_ba", "bow_keyframe", "loop_geometry", "loop_pose_graph"} <= names
