"""The rendered streams: one seed gives one stream, and the ground truth
puts each quad where the frame shows it."""

import copy

import numpy as np
import torch

from portbench import scene, spec


def small(name, frames=6, quads=None):
    cfg = copy.deepcopy(spec.load_json(spec.HERE / "configs" / f"{name}.json"))
    cfg["camera"].update({"width": 320, "height": 240, "fx": 300.0, "fy": 300.0, "cx": 160.0, "cy": 120.0})
    cfg["sequence"]["num_frames"] = frames
    if quads is not None:
        cfg["scene"]["num_quads"] = quads
    return cfg


def test_one_seed_one_stream():
    for name in ("kitti_odom", "tum_fr1"):
        cfg = small(name)
        a = scene.render(cfg, 2**31 + 17, "cpu")
        b = scene.render(cfg, 2**31 + 17, "cpu")
        c = scene.render(cfg, 5, "cpu")
        assert torch.equal(a.frames, b.frames) and np.array_equal(a.gt_poses, b.gt_poses)
        assert not torch.equal(a.frames, c.frames)
        assert np.array_equal(a.gt_poses, c.gt_poses), "the path is the configuration's, whatever the seed"
        assert a.frames.dtype == torch.uint8 and a.frames.shape == (6, 240, 320)


def test_ground_truth_reprojects_the_quad_corners():
    cfg = small("tum_fr1", frames=4, quads=1)
    cfg["scene"].update({"noise_sigma": 0.0, "x_m": [-0.05, 0.05], "y_m": [-0.05, 0.05], "z_m": [1.0, 1.0]})
    rendered = scene.render(cfg, 7, "cpu")
    quad = rendered.quads
    K = rendered.intrinsics
    checked = 0
    for frame, pose in zip(rendered.frames.numpy(), rendered.gt_poses):
        centre = quad["centres"][0]
        half = quad["half"][0]
        for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            world = centre + np.array([sx * half, sy * half, 0.0])
            cam = pose[:3, :3].T @ (world - pose[:3, 3])
            u, v = (K @ (cam / cam[2]))[:2]
            # A pixel just inside the corner shows the texture (>= 40); one
            # just outside shows the background (0).
            ix, iy = int(round(u - 2 * sx)), int(round(v - 2 * sy))
            ox, oy = int(round(u + 2 * sx)), int(round(v + 2 * sy))
            if 0 <= min(ix, ox) and max(ix, ox) < frame.shape[1] and 0 <= min(iy, oy) and max(iy, oy) < frame.shape[0]:
                assert frame[iy, ix] >= 35, (u, v)
                assert frame[oy, ox] == 0, (u, v)
                checked += 1
    assert checked >= 8


def test_ping_pong_replays_without_repeating_the_ends():
    seq = [scene.ping_pong(i, 4) for i in range(10)]
    assert seq == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]


def test_paths_have_the_configured_speeds():
    kitti = spec.load_json(spec.HERE / "configs" / "kitti_odom.json")
    poses = scene.camera_path(kitti)
    step = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    assert np.allclose(step, kitti["motion"]["speed_m_per_frame"])
    tum = spec.load_json(spec.HERE / "configs" / "tum_fr1.json")
    poses = scene.camera_path(tum)
    rate = tum["camera"]["rate_hz"]
    speed = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1).mean() * rate
    assert abs(speed - tum["motion"]["mean_speed_m_s"]) < 0.02
