"""The comparison that decides ``correct``, on the CPU at a small size:
a sound run passes, the control (the reference in bfloat16 in the
program's place) fails, and so does a run with the timed path broken
underneath. These skip the harness's look for a card and drive the rest
of a run (``run.run_cell(device="cpu")``); on an H100 the cells run at
their own size."""

import math

import numpy as np
import pytest
import torch

from portbench import run
from portbench.reference.judge import verdict

SMALL = {
    "config": {
        "camera": {"width": 320, "height": 240, "fx": 300.0, "fy": 300.0, "cx": 160.0, "cy": 120.0, "rate_hz": 10.0},
        "sequence": {"num_frames": 30},
    },
    "traffic": {"window": 4, "windows_per_dispatch": 2, "warmup_frames": 4, "trace_seconds": 0.5,
                "judge": {"sample": 4, "keep": 8192}},
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_run(cell, seconds=2.0, **kw):
    import copy

    return run.run_cell(cell, 2**31 + 11, seconds, False, device="cpu", overrides=copy.deepcopy(SMALL), **kw)


def limits(res):
    return {k: v["limit"] for k, v in res["checks"].items()}


def numbers(res):
    return {k: v["value"] for k, v in res["checks"].items()}


def test_a_sound_run_passes_and_the_control_fails():
    res = small_run("kitti.track", control=True)
    assert res["correct"], res["checks"]
    assert res["judge"]["anchors"] == 4 and res["judge"]["frames_checked"] >= 4
    assert not verdict(res["control_checks"], limits(res)), res["control_checks"]


def live_run(**kw):
    import copy

    ov = copy.deepcopy(SMALL)
    ov["config"] = {"sequence": {"num_frames": 30}}  # the camera at its own size
    ov["cell"] = {"rate_hz": 4.0}
    return run.run_cell("tum.live", 2**31 + 12, 3.0, False, device="cpu", overrides=ov, **kw)


def test_the_live_path_is_judged_on_what_it_handed_back():
    res = live_run(control=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] == 12
    assert set(res["metrics"]) == {"setup_s", "pose_latency_p50_ms", "pose_latency_p90_ms"}
    assert not verdict(res["control_checks"], limits(res)), res["control_checks"]


@pytest.mark.parametrize("cell", ["kitti.track", "tum.live"])
def test_an_answer_altered_where_it_is_produced_fails(monkeypatch, cell):
    from mvslam_tpu_torch.slam import tracking

    original = tracking._detect_describe

    def flipped(frames, cfg):
        out = original(frames, cfg)
        desc = out.descriptors.clone()
        desc[..., 0] ^= 1  # one bit of every descriptor, where K2's tiles become bits
        return out._replace(descriptors=desc)

    monkeypatch.setattr(tracking, "_detect_describe", flipped)
    res = small_run(cell) if cell == "kitti.track" else live_run()
    assert not res["correct"], numbers(res)


def test_a_tracking_step_that_returns_its_state_unchanged_fails(monkeypatch):
    from mvslam_tpu_torch.slam import api

    original = api.match_and_estimate
    first = []

    def stale(key, prev, cur, *args):
        # Every frame is matched against the first one: the carried
        # features never advance.
        first.append(prev)
        return original(key, first[0], cur, *args)

    monkeypatch.setattr(api, "match_and_estimate", stale)
    res = live_run()
    assert not res["correct"], numbers(res)


@pytest.mark.parametrize("state", ["carried_features", "pose_chain"])
def test_the_superwindow_with_its_state_unchanged_fails(monkeypatch, state):
    from mvslam_tpu_torch.slam import api, tracking

    if state == "carried_features":
        original = tracking._track_pairs

        def stale(keys, f1, f2, *args):
            # Every pair of a window is matched against the window's first
            # source frame: the carried features never advance.
            f1 = type(f1)(*(a[:1].expand_as(a).contiguous() for a in f1))
            return original(keys, f1, f2, *args)

        monkeypatch.setattr(tracking, "_track_pairs", stale)
    else:
        original = api.SLAMSystem._handle_tracked_frame

        def unchanged(self, *args):
            # The pose chain is never updated.
            pose = self._pose.copy()
            original(self, *args)
            self._pose = pose

        monkeypatch.setattr(api.SLAMSystem, "_handle_tracked_frame", unchanged)
    res = small_run("kitti.track")
    assert not res["correct"], numbers(res)


@pytest.mark.parametrize("cell", ["kitti.track", "tum.live"])
def test_posed_frames_without_features_fail(monkeypatch, cell):
    from mvslam_tpu_torch.backend import keyframes

    # The program keeps no keyframe: every sampled frame it posed reads off.
    monkeypatch.setattr(keyframes.KeyframeManager, "should_add", lambda self, pose, ratio: False)
    res = small_run(cell) if cell == "kitti.track" else live_run()
    assert res["judge"]["keypoints_off"] > 0
    assert not res["correct"], numbers(res)


def test_half_the_batch_left_out_fails(monkeypatch):
    from mvslam_tpu_torch.slam import tracking

    original = tracking._detect_describe

    def half(frames, cfg):
        # Detect on every other frame and repeat it for the next one.
        if frames.shape[0] < 2:
            return original(frames, cfg)
        kept = original(frames[::2], cfg)
        return type(kept)(*(torch.repeat_interleave(a, 2, dim=0)[: frames.shape[0]] for a in kept))

    monkeypatch.setattr(tracking, "_detect_describe", half)
    res = small_run("kitti.track")
    assert not res["correct"], numbers(res)


def test_window_ba_that_moves_the_keyframes_wrong_fails(monkeypatch):
    from mvslam_tpu_torch.backend import bundle_adjustment

    original = bundle_adjustment.WindowBundleAdjuster.refine_window

    def skewed(self, window, key=None):
        result = original(self, window, key=key)
        for k, kf in enumerate(window[1:], 1):
            a = math.radians(2.0 * k)
            c, s = math.cos(a), math.sin(a)
            kf.pose = kf.pose @ np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1.0]])
        return result

    monkeypatch.setattr(bundle_adjustment.WindowBundleAdjuster, "refine_window", skewed)
    res = live_run()
    assert not res["correct"], numbers(res)
