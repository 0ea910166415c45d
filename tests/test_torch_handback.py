"""``SLAMSystem.run_stream_async`` hands each frame back as soon as its
features are ready: the source is pulled on a thread of its own
(``runtime/packet_pump.py``), one packet ahead of the submits, and the
caller's thread wakes for the next packet, a ready feature result or a
pending frame's TTL, whichever comes first.

A source that blocks until the frame before is handed back stands for a
camera: before, such a frame waited for the next packet; a source that never
blocks (a list) keeps the order of before, submit one, then drain. This file
imports no JAX.
"""

import itertools
import threading
import time

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)

from mvslam_tpu_torch.backend.keyframes import KeyframeConfig
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
from mvslam_tpu_torch.runtime import feature_plane as tfplane
from mvslam_tpu_torch.runtime.frame_stream import FramePacket, packets_from_arrays
from mvslam_tpu_torch.runtime.tracking_plane import TrackingControlConfig
from mvslam_tpu_torch.slam import api as tapi

NUM_FRAMES = 5
LIMIT_S = 10.0  # the longest a source waits for a hand-back before it fails the test
LONG_TTL = TrackingControlConfig(frame_ttl_s=120.0)


def _frames(num=NUM_FRAMES, h=96, w=160, shift=4):
    """A textured plane sliding sideways (``test_torch_runtime.py``'s scene)."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 30, size=(h, w + shift * num)).astype(np.float32)
    for _ in range(80):
        y, x, s = rng.integers(22, h - 28), rng.integers(22, base.shape[1] - 28), rng.integers(3, 7)
        base[y : y + s, x : x + s] = rng.uniform(140, 255)
    return [base[:, i * shift : i * shift + w].copy() for i in range(num)]


def _system(root, run_id):
    """The default system configuration (window BA, relocalization and
    snapshots on) at a small size."""
    return tapi.SLAMSystem(
        tapi.SLAMSystemConfig(
            run_id=run_id, output_root=root, seed=1, fx=100.0, fy=100.0, cx=80.0, cy=48.0,
            feature=FeaturePipelineConfig(num_features=128, max_matches=64),
            pose=RobustPoseEstimatorConfig(num_hypotheses=64), keyframe=KeyframeConfig(min_translation=0.05),
        ),
        device="cpu",
    )


def _wait_for_handback(system, frame_id):
    """Block until ``frame_id``'s diagnostics are in ``system.diagnostics``;
    fail after ``LIMIT_S`` (the frame waited for the next packet)."""
    deadline = time.monotonic() + LIMIT_S
    while not any(d.frame_id == frame_id for d in list(system.diagnostics)):
        if time.monotonic() > deadline:
            raise AssertionError(f"frame {frame_id} was not handed back within {LIMIT_S} s of its successor's pull")
        time.sleep(0.002)


def _blocking_source(system, frames):
    """Each frame after the first only once the frame before is handed back."""
    for i, frame in enumerate(frames):
        if i:
            _wait_for_handback(system, i - 1)
        yield FramePacket(index=i, timestamp=float(i), frame=frame)


def _strip(diags):
    return [{k: v for k, v in d.to_dict().items() if k != "correlation_id"} for d in diags]


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    """The frames through ``process_frame``, one at a time."""
    system = _system(tmp_path_factory.mktemp("single"), "single")
    diags = [system.process_frame(f, float(i)) for i, f in enumerate(_frames())]
    return system, diags


@pytest.mark.parametrize("source", ["list", "blocking"])
def test_handback_equals_process_frame(source, single, tmp_path):
    """A list and a source that blocks until the frame before is handed
    back (it fails if a frame waits for the next packet) give the
    trajectory and diagnostics of ``process_frame``, bit for bit."""
    system = _system(tmp_path, source)
    frames = _frames()
    packets = packets_from_arrays(frames) if source == "list" else _blocking_source(system, frames)
    diags = system.run_stream_async(packets, tracking_control_config=LONG_TTL)
    single_system, single_diags = single
    assert [d.frame_id for d in diags] == list(range(NUM_FRAMES))
    assert sum(d.pose_success for d in diags[1:]) >= 3 and sum(d.is_keyframe for d in diags) >= 2
    assert np.array_equal(np.stack(system.trajectory.poses), np.stack(single_system.trajectory.poses))
    assert _strip(diags) == _strip(single_diags)


def test_ready_wake_span_per_frame_handed_back_early(tmp_path):
    """With a source that blocks until the frame before is handed back,
    every frame is tracked on the readiness signal: one ``ready_wake`` span
    each, from its features' ready moment (its ``ready_wait``'s start) to
    the caller's wake-up, on the caller's thread under ``run_stream_async``.
    The pulls are ``input_wait`` spans on the pump's thread, one a frame."""
    system = _system(tmp_path, "wake")
    system.run_stream_async(_blocking_source(system, _frames()), tracking_control_config=LONG_TTL)
    events = system.telemetry.events()
    (root,) = [e for e in events if e.name == "run_stream_async"]

    def of(name):
        return {e.metadata["frame_id"]: e for e in events if e.name == name and "frame_id" in e.metadata}

    wakes, waits, pulls = of("ready_wake"), of("ready_wait"), of("input_wait")
    assert len([e for e in events if e.name == "ready_wake"]) == NUM_FRAMES
    assert sorted(wakes) == sorted(waits) == sorted(pulls) == list(range(NUM_FRAMES))
    for f, wake in wakes.items():
        wait = waits[f]
        assert wake.start_s == wait.start_s and wake.timestamp_s <= wait.timestamp_s
        assert wake.parent_id == wait.parent_id == root.span_id and wake.thread == root.thread
        assert pulls[f].thread == "packet-pump"


def test_ttl_expiry_is_handed_back_without_a_further_packet(tmp_path, monkeypatch):
    """A frame whose features take longer than its TTL, while the source has
    nothing more to give: it is handed back as ``deadline_expired`` at its
    deadline, before the source yields again."""
    extract = tfplane.FeatureControlPlane._extract_batch

    def slow(self, batch):
        time.sleep(2.0)  # ten times the TTL
        extract(self, batch)

    monkeypatch.setattr(tfplane.FeatureControlPlane, "_extract_batch", slow)
    system = _system(tmp_path, "ttl")

    def source():
        yield FramePacket(index=0, timestamp=0.0, frame=_frames(1)[0])
        _wait_for_handback(system, 0)

    diags = system.run_stream_async(source(), tracking_control_config=TrackingControlConfig(frame_ttl_s=0.2))
    assert [(d.frame_id, d.failure_reason, d.pose_success) for d in diags] == [(0, "deadline_expired", False)]


@pytest.mark.parametrize("failing", ["source", "caller"])
def test_a_stop_closes_the_source_the_pump_and_the_plane(failing, tmp_path, monkeypatch):
    """The source raises mid-stream, or the caller's tracking raises: the
    exception reaches the caller, the source is closed, no pump thread stays
    alive, the feature plane is closed and the report written."""
    planes = []
    close = tfplane.FeatureControlPlane.close

    def recorded_close(self):
        planes.append(self)
        close(self)

    monkeypatch.setattr(tfplane.FeatureControlPlane, "close", recorded_close)
    if failing == "caller":
        def broken(*args, **kwargs):
            raise RuntimeError("tracking failed")

        monkeypatch.setattr(tapi.SLAMSystem, "_handle_tracked_frame", broken)
    closed = threading.Event()
    frames = _frames(3)

    def source():
        try:
            for i in itertools.count():
                if failing == "source" and i == 2:
                    raise RuntimeError("camera lost")
                yield FramePacket(index=i, timestamp=float(i), frame=frames[i % len(frames)])
        finally:
            closed.set()

    system = _system(tmp_path, failing)
    with pytest.raises(RuntimeError, match="camera lost" if failing == "source" else "tracking failed"):
        system.run_stream_async(source(), tracking_control_config=LONG_TTL)
    assert closed.is_set()
    assert not [t for t in threading.enumerate() if t.name == "packet-pump"]
    assert len(planes) == 1 and planes[0]._closed and not planes[0]._assembler.is_alive()
    assert set(system.store.load_report("control_plane_report")["snapshots"]) == {"feature", "tracking"}


@pytest.mark.parametrize("packets,notifiers", [(3, 0), (2000, 4)], ids=["three", "stressed"])
def test_pump_hands_over_one_packet_at_a_time(packets, notifiers):
    """The pump pulls the next packet only after the caller frees the slot,
    and marks the source's end; stressed, with a short switch interval and
    other threads notifying the same condition as the feature plane does,
    every packet arrives once, in order, one ahead at most."""
    import sys

    from mvslam_tpu_torch.runtime.packet_pump import PacketPump

    pulled = []

    def source():
        for i in range(packets):
            pulled.append(i)
            yield i

    signal = threading.Condition()
    stop = threading.Event()

    def notify():
        while not stop.is_set():
            with signal:
                signal.notify_all()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6 if notifiers else interval)
    threads = [threading.Thread(target=notify, daemon=True) for _ in range(notifiers)]
    pump = PacketPump(source(), signal)
    got = []
    try:
        for t in threads:
            t.start()
        pump.start()
        while True:
            with signal:
                assert signal.wait_for(pump.ready, LIMIT_S)
                packet = pump.take()
                assert len(pulled) == len(got) + (packet is not PacketPump.END)
            if packet is PacketPump.END:
                break
            got.append(packet)
            pump.advance()
    finally:
        stop.set()
        pump.close()
        for t in threads:
            t.join(LIMIT_S)
        sys.setswitchinterval(interval)
    assert got == list(range(packets))
    assert not pump._thread.is_alive() and not any(t.is_alive() for t in threads)
