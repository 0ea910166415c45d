"""The port's viz package and demo helpers (``mvslam_tpu_torch/viz``,
``data/demo_utils.py``) against the JAX package's, and the offline
pipeline's animation hook.

The viz modules are numpy host code: the yaw clamp, the recorder, the
Euler angles, the status classes, the viewer's status log and the
dashboard's JSON are held equal to the reference's exactly. Rendering and
the websocket/HTTP round trip run where matplotlib and ``websockets`` are
installed. No test touches the network: the download is monkeypatched.
"""

import json
import math
import socket
import time
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)

from mvslam_tpu.data import demo_utils as jdemo
from mvslam_tpu.viz import dashboard_server as jdash
from mvslam_tpu.viz import path_animator as janim
from mvslam_tpu.viz import viewer as jviewer
from mvslam_tpu_torch.data import demo_utils as tdemo
from mvslam_tpu_torch.viz import dashboard_server as tdash
from mvslam_tpu_torch.viz import path_animator as tanim
from mvslam_tpu_torch.viz import viewer as tviewer


def _rotation(rng):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _poses(n=40, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        T = np.eye(4)
        T[:3, :3] = _rotation(rng)
        T[:3, 3] = rng.normal(size=3) * i
        out.append(T)
    return out


def test_yaw_clamp_recorder_and_euler_angles_equal_reference():
    rng = np.random.default_rng(1)
    for _ in range(200):
        a, b, step = rng.uniform(-10, 10), rng.uniform(-10, 10), rng.uniform(0.1, 30)
        assert tanim.clamp_yaw_rate(a, b, step) == janim.clamp_yaw_rate(a, b, step)
    ours, ref = tanim.TrajectoryRecorder(max_yaw_step_deg=3.0), janim.TrajectoryRecorder(max_yaw_step_deg=3.0)
    for pose in _poses():
        ours.update(pose)
        ref.update(pose)
    for rec in (ours, ref):
        rec.set_optimized([(1.0, 2.0), (3.0, 4.0)])
        rec.add_loop_edge(3, np.int64(7))
    assert (ours.positions, ours.optimized, ours.loop_edges, ours.yaw) == (ref.positions, ref.optimized, ref.loop_edges, ref.yaw)
    assert len(ours.positions) == 40
    for pose in _poses(seed=2) + [np.diag([1.0, 1.0, 1.0, 1.0]), np.array([[0, 0, -1, 0], [0, 1, 0, 0], [1, 0, 0, 0], [0, 0, 0, 1.0]])]:
        assert tviewer.rotation_to_euler_deg(pose[:3, :3]) == jviewer.rotation_to_euler_deg(pose[:3, :3])


def test_status_classes_equal_reference():
    for matches in (0, 39, 40, 41, 500):
        for ratio in (0.0, 0.19, 0.2, 0.34, 0.35, 0.9):
            assert tviewer.classify_status(matches, ratio) == jviewer.classify_status(matches, ratio)
    assert tviewer.classify_status(100, 0.8)[0] == "Tracking stable"


class _ScriptedSystem:
    """``process_frame`` and ``pose`` of a system that replays given poses."""

    def __init__(self, poses):
        self._poses = poses
        self._i = -1

    def process_frame(self, frame, timestamp):
        self._i += 1
        return SimpleNamespace(frame_id=self._i, timestamp=timestamp, num_features=100 + self._i,
                               num_matches=50 + self._i, num_inliers=40, inlier_ratio=0.8, pose_success=True,
                               model_type="essential")

    @property
    def pose(self):
        return self._poses[self._i]


def test_dashboard_json_equals_reference():
    status = dict(frame_id=1, timestamp=0.1, num_matches=10, graph_edges=[[0, 1]], progress=0.5)
    assert tdash.FrameStatus(**status).to_json() == jdash.FrameStatus(**status).to_json()
    frames = [np.zeros((4, 4), np.uint8)] * 6
    poses = _poses(6, seed=3)
    ours = [s.to_json() for s in tdash.DashboardStream(_ScriptedSystem(poses), frames)]
    ref = [s.to_json() for s in jdash.DashboardStream(_ScriptedSystem(poses), frames)]
    assert ours == ref and json.loads(ours[-1])["progress"] == 1.0


def test_dashboard_stream_drives_the_ports_system(tmp_path):
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    rng = np.random.default_rng(0)
    num, h, w, shift = 4, 96, 128, 4
    base = rng.uniform(0, 30, size=(h, w + shift * num)).astype(np.float32)
    for _ in range(80):
        y, x, s = rng.integers(22, h - 28), rng.integers(22, base.shape[1] - 28), rng.integers(3, 7)
        base[y : y + s, x : x + s] = rng.uniform(140, 255)
    system = SLAMSystem(
        SLAMSystemConfig(run_id="dash", output_root=tmp_path, fx=100.0, fy=100.0, cx=64.0, cy=48.0,
                         feature=FeaturePipelineConfig(num_features=128, max_matches=64),
                         pose=RobustPoseEstimatorConfig(num_hypotheses=64), enable_local_ba=False,
                         enable_relocalization=False, persist_map_snapshot=False),
        device="cpu",
    )
    statuses = list(tdash.DashboardStream(system, [base[:, i * shift : i * shift + w].copy() for i in range(num)]))
    assert len(statuses) == 4 and statuses[-1].progress == pytest.approx(1.0)
    assert len(statuses[-1].trajectory) == 4
    assert statuses[-1].pose_matrix == system.pose.tolist()


def test_viewer_status_log_and_render_equal_reference(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.setenv("MPLBACKEND", "Agg")
    rng = np.random.default_rng(0)
    frame = rng.uniform(0, 255, size=(96, 128)).astype(np.float32)
    kp = rng.uniform(0, 90, size=(50, 2)).astype(np.float32)
    viewers = [mod.SlamViewer(interactive=False, total_frames=3) for mod in (tviewer, jviewer)]
    for i, ratio in enumerate((0.83, 0.3, 0.1)):
        pose = np.eye(4)
        pose[0, 3] = float(i)
        diag = SimpleNamespace(num_features=50, num_matches=48, inlier_ratio=ratio)
        for v in viewers:
            v.update(frame, kp, pose, matches=(kp, kp + 2.0, np.arange(50) % 5 != 0), diagnostics=diag)
    ours, ref = viewers
    assert (ours.status_log, ours.last_status, ours.trajectory) == (ref.status_log, ref.last_status, ref.trajectory)
    assert ours.last_status == "Tracking lost"
    out = tmp_path / "viewer.png"
    ours.render_frame_png(out)
    assert out.stat().st_size > 1000


def test_render_png(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    monkeypatch.setenv("MPLBACKEND", "Agg")
    anim = tanim.VehiclePathLiveAnimator()
    for pose in _poses(10):
        anim.update(pose)
    anim.set_optimized([(0.0, 0.0), (1.0, 1.0)])
    anim.add_loop_edge(0, 5)
    anim.render_png(tmp_path / "path.png")
    assert (tmp_path / "path.png").stat().st_size > 1000


def test_ws_http_round_trip():
    pytest.importorskip("websockets")
    import asyncio

    def free_port():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]

    ws_port, http_port = free_port(), free_port()
    server = tdash.DashboardServer(ws_port=ws_port, http_port=http_port)
    server.start()
    try:
        time.sleep(0.3)
        html = urllib.request.urlopen(f"http://127.0.0.1:{http_port}/index.html", timeout=3).read()
        assert b"live dashboard" in html

        async def ws_once():
            import websockets

            async with websockets.connect(f"ws://127.0.0.1:{ws_port}") as ws:
                server.broadcast(tdash.FrameStatus(frame_id=7, timestamp=0.7))
                return json.loads(await asyncio.wait_for(ws.recv(), timeout=3))

        assert asyncio.run(ws_once())["frame_id"] == 7
    finally:
        server.stop()
    assert not any(t.is_alive() for t in server._threads)


def test_animation_is_bit_equal_to_a_run_without_it(tmp_path, monkeypatch):
    """``run_visual_slam(enable_animation=True)`` on the CPU: the same
    trajectory and summary as without, and the recorder holds one position
    per frame, the system's live x/z."""
    from mvslam_tpu_torch.data.synthetic import render_scene, write_kitti_sequence
    from mvslam_tpu_torch.slam import offline as toffline

    monkeypatch.setenv("MPLBACKEND", "Agg")
    frames, gt, intrinsics, _ = render_scene(num_frames=7, h=120, w=160, seed=2, noise=2.0,
                                            traj_fn=lambda i: (np.eye(3), np.array([0.2 * i, 0.0, 0.05 * i])))
    root, gt_path = write_kitti_sequence(tmp_path / "kitti", frames, gt, intrinsics)
    made = []

    class Recorded(tanim.VehiclePathLiveAnimator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.handed = []
            made.append(self)

        def update(self, pose):
            self.handed.append(np.array(pose))
            super().update(pose)

    monkeypatch.setattr(tanim, "VehiclePathLiveAnimator", Recorded)
    runs = {}
    for animate in (False, True):
        cfg = toffline.SLAMRunConfig(input_path=root, output_root=tmp_path / f"runs{animate}", window=2,
                                     ground_truth_path=gt_path, enable_animation=animate, loop_min_frame_gap=3)
        summary = toffline.run_visual_slam(cfg, device="cpu")
        run_dir = summary.pop("run_dir")
        with np.load(f"{run_dir}/trajectories/estimated.npz") as data:
            runs[animate] = (summary, data["poses"].copy())
    assert json.dumps(runs[True][0], sort_keys=True) == json.dumps(runs[False][0], sort_keys=True)
    poses = runs[True][1]
    assert np.array_equal(poses, runs[False][1]) and len(poses) == 7
    (anim,) = made
    assert anim._thread is None  # stopped
    # The system's live pose at each frame (window BA may refine a past
    # keyframe's pose in the trajectory afterwards).
    assert anim.positions == [(float(p[0, 3]), float(p[2, 3])) for p in anim.handed] and len(anim.positions) == 7
    assert anim.positions[0] == (float(poses[0, 0, 3]), float(poses[0, 2, 3]))


def test_demo_download_error_and_synthetic_fallback(tmp_path, monkeypatch):
    def offline(url, target):
        raise OSError("no route to host")

    for mod in (tdemo, jdemo):
        monkeypatch.setattr(mod.urllib.request, "urlretrieve", offline)
        with pytest.raises(RuntimeError, match="generate_synthetic_video"):
            mod.ensure_sample_video(tmp_path / mod.__name__ / "clip.mp4")
    fetched = []
    monkeypatch.setattr(tdemo.urllib.request, "urlretrieve", lambda url, target: fetched.append(url) or target.write_bytes(b"x"))
    target = tmp_path / "fetched.mp4"
    assert tdemo.ensure_sample_video(target) == target and fetched == [tdemo.SAMPLE_VIDEO_URL]
    assert tdemo.ensure_sample_video(target) == target and len(fetched) == 1  # present: not fetched again
    assert tdemo.SAMPLE_VIDEO_URL == jdemo.SAMPLE_VIDEO_URL
    cv2 = pytest.importorskip("cv2")
    ours = tdemo.generate_synthetic_video(tmp_path / "ours.mp4", num_frames=6, h=48, w=64)
    ref = jdemo.generate_synthetic_video(tmp_path / "ref.mp4", num_frames=6, h=48, w=64)
    assert ours.read_bytes() == ref.read_bytes()
    cap = cv2.VideoCapture(str(ours))
    try:
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 6
    finally:
        cap.release()
