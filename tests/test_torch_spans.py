"""The port's spans: one clock, links to their parents, the offline and live
paths' spans per dispatch and per frame, window BA's three parts, and, on
the card, device spans against the profiler's kernel records.

This file imports no JAX: on a machine without it run the card test with
``python -m pytest tests/test_torch_spans.py -m cuda -q --noconftest -p no:cacheprovider``.
"""

import dataclasses
import itertools
import time

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)

from mvslam_tpu_torch.backend import bundle_adjustment as tba
from mvslam_tpu_torch.backend.keyframes import Keyframe, KeyframeConfig
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.core import telemetry as ttel
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
from mvslam_tpu_torch.runtime.frame_stream import FramePacket
from mvslam_tpu_torch.runtime.tracking_plane import TrackingControlConfig
from mvslam_tpu_torch.slam import api as tapi


def _by_id(events):
    return {e.span_id: e for e in events}


def test_span_stamps_are_one_monotonic_clock():
    rec = ttel.RunTelemetryRecorder()
    before = time.time()
    with ttel.timed_event(rec, "outer"):
        for i in range(3):
            with ttel.timed_event(rec, "inner", metadata={"frame_id": i}):
                sum(range(1000))
    after = time.time()
    events = rec.events()
    assert [e.name for e in events] == ["inner"] * 3 + ["outer"]
    for e in events:
        assert e.timestamp_s - e.duration_s == e.start_s and e.duration_s >= 0
        assert before - 0.01 <= e.start_s <= e.timestamp_s <= after + 0.01
    inner = events[:3]
    assert all(a.timestamp_s <= b.start_s for a, b in zip(inner, inner[1:]))
    outer = events[-1]
    assert outer.start_s <= inner[0].start_s and inner[-1].timestamp_s <= outer.timestamp_s
    assert {e.parent_id for e in inner} == {outer.span_id} and outer.parent_id is None
    assert len({e.span_id for e in events}) == 4 and {e.thread for e in events} == {"MainThread"}


def test_an_injected_clock_stamps_every_span():
    ticks = itertools.count()
    rec = ttel.RunTelemetryRecorder(clock=lambda: float(next(ticks)))
    with ttel.timed_event(rec, "stage"):
        pass
    rec.record("given", 0.5)
    stage, given = rec.events()
    assert (stage.start_s, stage.timestamp_s, stage.duration_s) == (0.0, 1.0, 1.0)
    assert (given.timestamp_s, given.duration_s, given.start_s) == (2.0, 0.5, 1.5)
    assert stage.to_dict()["span_id"] == stage.span_id and "start_s" not in stage.to_dict()


def _config(root, run_id, intrinsics, **kw):
    fx, fy, cx, cy = intrinsics
    return tapi.SLAMSystemConfig(
        run_id=run_id, output_root=root, seed=1, fx=fx, fy=fy, cx=cx, cy=cy,
        feature=FeaturePipelineConfig(num_features=128, max_matches=64), pose=RobustPoseEstimatorConfig(num_hypotheses=64),
        keyframe=KeyframeConfig(min_translation=0.05), **kw,
    )


@pytest.fixture(scope="module")
def offline(tmp_path_factory):
    """``run_sequence`` over 1 + 16 rendered frames, window 4, two windows a
    dispatch: two dispatches."""
    from mvslam_tpu_torch.data.synthetic import render_scene

    frames, _, intrinsics, _ = render_scene(num_frames=17, h=96, w=160, seed=0, n_pts=200)
    cfg = _config(tmp_path_factory.mktemp("spans"), "offline", intrinsics,
                  enable_local_ba=False, enable_relocalization=False, persist_map_snapshot=False)
    system = tapi.SLAMSystem(cfg, device="cpu")
    diags = system.run_sequence([np.asarray(f) for f in frames], window=4, windows_per_dispatch=2)
    return system, diags


def test_run_sequence_spans_have_parents_and_one_of_each_per_dispatch(offline):
    system, diags = offline
    events = system.telemetry.events()
    spans = _by_id(events)
    roots = [e for e in events if e.parent_id is None]
    assert [e.name for e in roots] == ["run_sequence"]
    assert all(e.parent_id in spans for e in events if e is not roots[0])
    for name in ("dispatch_stage", "track_enqueue", "scalar_pull"):
        per_dispatch = [e for e in events if e.name == name]
        assert len(per_dispatch) == 2, name
        assert {e.parent_id for e in per_dispatch} == {roots[0].span_id}
    assert [e.metadata["frames"] for e in events if e.name == "dispatch_stage"] == [8, 8]
    assert [e.metadata["start"] for e in events if e.name == "track_enqueue"] == [1, 9]
    frames = [e for e in events if e.name == "frame_process"]
    assert sorted(e.metadata["frame_id"] for e in frames) == [d.frame_id for d in diags] == list(range(17))
    pulls = [e for e in events if e.name == "keyframe_pull"]
    assert pulls and all(spans[e.parent_id].name == "frame_process" for e in pulls)
    # Every child lies inside its parent on the one clock.
    for e in events:
        if e.parent_id is not None:
            p = spans[e.parent_id]
            assert p.start_s <= e.start_s <= e.timestamp_s <= p.timestamp_s, (e.name, p.name)


def test_pose_estimate_is_no_longer_recorded(offline, tmp_path):
    system, _ = offline
    single = tapi.SLAMSystem(dataclasses.replace(system.config, run_id="single", output_root=tmp_path), device="cpu")
    frames = [np.asarray(f) for f in _live_frames(num=4)]
    single.run_sequence(frames, window=1)
    names = {e.name for e in system.telemetry.events()} | {e.name for e in single.telemetry.events()}
    assert "track_step" in names and "frame_process" in names
    assert "pose_estimate" not in names and "track_window" not in names
    assert not any(n.endswith(".device") for n in names)  # the CPU records no device span


def _live_frames(num=6, h=96, w=160, shift=4):
    """A textured plane sliding sideways (``test_torch_runtime.py``'s scene)."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 30, size=(h, w + shift * num)).astype(np.float32)
    for _ in range(80):
        y, x, s = rng.integers(22, h - 28), rng.integers(22, base.shape[1] - 28), rng.integers(3, 7)
        base[y : y + s, x : x + s] = rng.uniform(140, 255)
    return [base[:, i * shift : i * shift + w].copy() for i in range(num)]


def test_run_stream_async_spans_follow_each_frame(tmp_path):
    system = tapi.SLAMSystem(_config(tmp_path, "live", (100.0, 100.0, 80.0, 48.0)), device="cpu")
    packets = [FramePacket(index=i, timestamp=float(i), frame=f) for i, f in enumerate(_live_frames())]
    diags = system.run_stream_async(packets, tracking_control_config=TrackingControlConfig(frame_ttl_s=120.0))
    events = system.telemetry.events()
    spans = _by_id(events)
    posed = [d.frame_id for d in diags if d.pose_success]
    assert len(posed) >= 4
    root = [e for e in events if e.name == "run_stream_async"]
    assert len(root) == 1 and root[0].parent_id is None

    def of(name, frame_id):
        return [e for e in events if e.name == name and e.metadata.get("frame_id") == frame_id]

    batches = [e for e in events if e.name == "feature_batch"]
    assert all(e.thread == "feature-batch-assembler" for e in batches + [e for e in events if e.name == "feature_queue"])
    for f in posed:
        (queue,), (ready,), (frame,) = of("feature_queue", f), of("ready_wait", f), of("frame_process", f)
        (batch,) = [b for b in batches if f in b.metadata["frame_ids"]]
        assert queue.timestamp_s <= batch.start_s + 1e-6 and batch.start_s <= ready.start_s <= batch.timestamp_s
        assert ready.timestamp_s <= frame.start_s
        assert ready.parent_id == frame.parent_id == root[0].span_id and len(of("input_wait", f)) == 1
    steps = [e for e in events if e.name == "track_step"]
    assert steps and all(spans[e.parent_id].name == "frame_process" for e in steps)
    assert sum(b.metadata["fill"] for b in batches) == len(diags)


def test_window_ba_spans_nest_inside_local_ba():
    rng = np.random.default_rng(0)
    n = 96
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(8, 16, n)], axis=1)
    desc = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    kfs = []
    for w in range(4):
        pose = np.eye(4)
        pose[0, 3] = 0.6 * w
        cam = pts - pose[:3, 3]
        uv = cam[:, :2] / cam[:, 2:] * 400 + [160, 120] + rng.normal(scale=0.3, size=(n, 2))
        kfs.append(Keyframe(frame_id=w, timestamp=0.1 * w, pose=pose, keypoints=uv.astype(np.float32),
                            descriptors=desc, valid=np.ones(n, bool)))
    rec = ttel.RunTelemetryRecorder()
    adjuster = tba.WindowBundleAdjuster(np.array([[400.0, 0, 160], [0, 400.0, 120], [0, 0, 1]]), device="cpu",
                                        recorder=rec)
    for window in (kfs[:3], kfs[1:]):
        with ttel.timed_event(rec, "local_ba"):
            assert adjuster.refine_window(window, key=prng.key(0)) is not None
    events = rec.events()
    outer = [e for e in events if e.name == "local_ba"]
    assert len(outer) == 2
    # Two pairs gated in the first window, the one new pair in the second.
    for ba, gates in zip(outer, (2, 1)):
        parts = [e for e in events if e.parent_id == ba.span_id]
        assert sorted(e.name for e in parts) == sorted(["ba_gate"] * gates + ["ba_tracks", "ba_solve"])
        assert sum(e.duration_s for e in parts) <= ba.duration_s
        assert all(ba.start_s <= e.start_s <= e.timestamp_s <= ba.timestamp_s for e in parts)


def test_a_descheduled_anchor_is_taken_again(monkeypatch):
    """The host times around an anchor event's stamp 1 ms apart (the thread
    descheduled): the clock anchors again, at the middle of the narrow
    bracket."""

    class Event:
        def __init__(self, enable_timing=False):
            pass

        def record(self, stream=None):
            pass

        def query(self):
            return True

    monkeypatch.setattr(torch.cuda, "Event", Event)
    # per attempt: before the record, before the query, after it
    reads = iter([0.0, 1e-3, 1.001e-3, 2e-3, 2.000005e-3, 2.00001e-3])
    clock = ttel._DeviceClock(lambda: next(reads))
    clock._take_anchor(stream=None)
    assert clock.anchor[1] == pytest.approx(2.000005e-3, abs=1e-12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (device spans record only on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_span_lies_on_the_profilers_kernel(cuda):
    """A ~2 ms ``torch.cuda._sleep`` kernel inside a host span and a device
    span, under ``torch.profiler`` with CUDA activity only, as the
    benchmark's trace runs it, in seven profiling sessions.

    In every session the device span lies inside its host span, to 0.05
    ms (its anchor's placement is good to ~0.015 ms), and lasts what the
    profiler's kernel lasts, to 0.1 ms: both sides of each are on one clock. Across the sessions, the median kernel lies inside the
    host span and the device span's median ends lie within 0.1 ms of the
    kernel's: the profiler converts each session's device times to unix
    time by its own calibration, which now and then places a whole session
    ~0.4 ms off on an H100's host. The span starts on an idle stream, so
    its start precedes the kernel by the kernel's launch; the first launch
    of a session pays the profiler's own set-up there (~0.4 ms), so one
    short launch goes first. The profiler drops a kernel's record now and
    then: a session without the ~2 ms kernel is run again."""
    import statistics

    from portbench.trace import DeviceTracer

    cycles = 2_000_000  # ~1-2 ms at the card's clock
    torch.cuda._sleep(cycles)  # warm
    torch.cuda.synchronize()
    offsets, sessions = [], 0
    while len(offsets) < 7 and sessions < 14:
        sessions += 1
        rec = ttel.RunTelemetryRecorder()
        with ttel.timed_event(rec, "warm"), ttel.device_span(rec, "warm", cuda):
            torch.cuda._sleep(1000)  # the first span anchors the device's clock
        torch.cuda.synchronize()
        tracer = DeviceTracer({})
        tracer.start()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        with ttel.timed_event(rec, "host"):
            with ttel.device_span(rec, "sleep", cuda):
                torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
        trace = tracer.stop(frames=0)
        kernels = [(s, e) for n, s, e in trace.ops if ("spin" in n or "sleep" in n) and e - s > 5e-4]
        if not kernels:
            continue
        ((k0, k1),) = kernels
        host = [e for e in rec.events() if e.name == "host"][0]
        dev = [e for e in rec.events() if e.name == "sleep.device"][0]
        assert dev.parent_id == host.span_id and dev.thread == "device"
        assert host.start_s - 5e-5 <= dev.start_s and dev.timestamp_s <= host.timestamp_s + 5e-5
        assert abs(dev.duration_s - (k1 - k0)) <= 1e-4
        offsets.append((k0 - host.start_s, host.timestamp_s - k1, dev.start_s - k0, dev.timestamp_s - k1))
    assert len(offsets) == 7, f"the profiler recorded the kernel in {len(offsets)} of {sessions} sessions"
    print("offsets_ms (kernel start - host start, host end - kernel end, device start - kernel start, "
          "device end - kernel end):", [[round(1e3 * x, 4) for x in o] for o in offsets])
    inside_start, inside_end, d0, d1 = (statistics.median(o[i] for o in offsets) for i in range(4))
    assert inside_start >= 0 and inside_end >= 0
    assert abs(d0) <= 1e-4 and abs(d1) <= 1e-4
