"""The port's runtime control planes against the JAX package's.

Host modules (``ingestion_control``, ``hub``, ``supervisor``,
``failure_injection``): with clocks injected and the same inputs, the same
event sequences, snapshots and digests (string-equal). The feature and
tracking planes: the reference's own cases (``tests/test_runtime.py``)
through the port, and each frame's results bit-equal to the reference's
plane. The async ingestion pipeline over PNG files that the port wrote.
``SLAMSystem.run_stream_async`` in both packages, and in the port
bit-equal to its own ``process_frame`` run. The runner's ``async`` mode
bit-equal to its ``stream`` mode.
"""

import json
import threading
import time

import numpy as np
import pytest

import torch_parity  # noqa: F401  (one torch thread per worker)

from mvslam_tpu.backend.keyframes import KeyframeConfig as JKC
from mvslam_tpu.frontend.feature_pipeline import FeaturePipelineConfig as JFC
from mvslam_tpu.frontend.pose_estimator import RobustPoseEstimatorConfig as JPC
from mvslam_tpu.runtime import failure_injection as jfi
from mvslam_tpu.runtime import feature_plane as jfplane
from mvslam_tpu.runtime import hub as jhub
from mvslam_tpu.runtime import ingestion_control as jic
from mvslam_tpu.runtime import supervisor as jsup
from mvslam_tpu.runtime import tracking_plane as jtplane
from mvslam_tpu.runtime.frame_stream import packets_from_arrays as jpackets
from mvslam_tpu.slam import api as japi
from mvslam_tpu_torch.backend.keyframes import KeyframeConfig
from mvslam_tpu_torch.core.persistence import RunDataStore
from mvslam_tpu_torch.data.synthetic import write_png_gray
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipeline, FeaturePipelineConfig
from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
from mvslam_tpu_torch.runtime import failure_injection as tfi
from mvslam_tpu_torch.runtime import feature_plane as tfplane
from mvslam_tpu_torch.runtime import hub as thub
from mvslam_tpu_torch.runtime import ingestion as tingest
from mvslam_tpu_torch.runtime import ingestion_control as tic
from mvslam_tpu_torch.runtime import supervisor as tsup
from mvslam_tpu_torch.runtime import tracking_plane as ttplane
from mvslam_tpu_torch.runtime.frame_stream import _default_read_fn, packets_from_arrays
from mvslam_tpu_torch.slam import api as tapi

PORT, REF = "port", "ref"
MODS = {
    PORT: dict(ic=tic, hub=thub, sup=tsup, fi=tfi),
    REF: dict(ic=jic, hub=jhub, sup=jsup, fi=jfi),
}


class Clock:
    """An injected clock: time moves only when the test moves it."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


# ----------------------------------------------------------------------
# ingestion_control: one scenario per class, driven identically in both
# ----------------------------------------------------------------------


def _queue(m):
    ic = m["ic"]
    q = ic.AdaptiveBoundedQueue(3)
    out = [q.put(i, timeout=0.01) for i in range(4)]  # the 4th times out
    out += [q.get(timeout=0.01) for _ in range(2)]
    q.resize(5)
    out += [q.put(i, timeout=0.01) for i in range(10, 14)]
    out += [q.capacity, len(q), q.depth_ratio(), q.total_put, q.total_get, q.put_blocked]
    out += [q.get(timeout=0.01) for _ in range(6)]  # the 6th finds it empty
    with pytest.raises(ValueError):
        ic.AdaptiveBoundedQueue(0)
    return out


def _breaker(m):
    ic = m["ic"]
    clock = Clock()
    cb = ic.CircuitBreaker(ic.CircuitBreakerConfig(failure_threshold=3, recovery_timeout_s=1.0, half_open_successes=2), clock=clock)
    trace = []
    for t, op in [(0.0, "f"), (0.1, "s"), (0.2, "f"), (0.3, "f"), (0.4, "f"), (0.5, "a"), (1.6, "a"), (1.7, "f"),
                  (2.0, "a"), (2.8, "s"), (2.9, "s"), (3.0, "s"), (3.1, "f")]:
        clock.now = t
        if op == "f":
            cb.record_failure()
        elif op == "s":
            cb.record_success()
        else:
            trace.append(cb.allow())
        trace.append((t, cb.state, cb.trip_count))
    return trace


def _event_log(m):
    ic = m["ic"]
    clock = Clock()
    log = ic.DeterministicEventLog(capacity=4, clock=clock)
    for i in range(6):
        clock.now = 0.5 * i
        log.emit("frame_dropped" if i % 2 else "decode_error", message=f"m{i}", index=i, extra=[i, i + 1])
    return log.events(), log.total_emitted


def _reorder(m):
    ic = m["ic"]
    buf = ic.DeterministicReorderBuffer(ic.OrderingBufferConfig(max_pending=4, forced_flush_ratio=0.5))
    out = []
    for seq in (1, 2, 0, 5, 7, 6, 11, 9):
        buf.push(seq, f"item{seq}")
        out.append(buf.pop_ready())
    buf.push(20, "x")
    buf.push(15, "y")
    out += [buf.flush_all(), buf.forced_flushes, buf.skipped_seqs, len(buf)]
    return out


def _supervision(m):
    ic = m["ic"]
    clock = Clock()
    q = ic.AdaptiveBoundedQueue(4)
    pool = ic.DynamicWorkerPool(ic.WorkerPoolConfig(min_workers=1, max_workers=3))
    log = ic.DeterministicEventLog(clock=clock)
    sup = ic.StageSupervisor(q, pool, ic.QueueTuningConfig(min_capacity=2, max_capacity=16), log)
    ticks = []
    for step in range(12):
        clock.now = float(step)
        if step < 5:
            while q.put(step, timeout=0.0):
                pass
        else:
            while len(q):
                q.get(timeout=0.0)
        ticks.append(sup.tick())
    ema = ic.MovingAverage(alpha=0.25)
    emas = [ema.update(v) for v in (1.0, 0.0, 2.0, 0.5)]
    with pytest.raises(ValueError):
        ic.MovingAverage(alpha=0.0)
    return ticks, log.events(), pool.scale_ups, pool.scale_downs, emas, ema.value


def _failure_report(m):
    ic = m["ic"]
    report = ic.IngestionFailureReport(decoded=7, retries=2)
    for reason in ("decode_failed", "timeout", "decode_failed"):
        report.record_failure(reason)
    return report.to_dict()


def _orchestrator(m):
    ic = m["ic"]
    q = ic.AdaptiveBoundedQueue(8)
    sup = ic.StageSupervisor(q, ic.DynamicWorkerPool())
    orch = ic.ControlPlaneOrchestrator([sup], interval_s=0.005)
    orch.start()
    deadline = time.monotonic() + 5.0
    while sup.ticks < 3 and time.monotonic() < deadline:
        time.sleep(0.005)
    orch.stop()
    return sup.ticks >= 3, orch._thread is None, q.capacity < 8


@pytest.mark.parametrize(
    "scenario", [_queue, _breaker, _event_log, _reorder, _supervision, _failure_report, _orchestrator],
    ids=lambda f: f.__name__.strip("_"),
)
def test_ingestion_control_equals_reference(scenario):
    assert scenario(MODS[PORT]) == scenario(MODS[REF])


def test_queue_stress_loses_nothing():
    """Three producers and four consumers on a queue of 4, with a short
    switch interval: every item arrives exactly once."""
    import sys

    q = tic.AdaptiveBoundedQueue(4)
    got, lock = [], threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def producer(base):
            for i in range(200):
                assert q.put(base + i, timeout=10.0)

        def consumer():
            while True:
                ok, item = q.get(timeout=0.3)
                if not ok:
                    return
                with lock:
                    got.append(item)

        threads = [threading.Thread(target=producer, args=(k * 1000,)) for k in range(3)]
        threads += [threading.Thread(target=consumer) for _ in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=20.0)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(got) == sorted(k * 1000 + i for k in range(3) for i in range(200))
    assert q.total_put == q.total_get == 600


# ----------------------------------------------------------------------
# hub, supervisor, failure injection
# ----------------------------------------------------------------------


def _stage_events(seed):
    rng = np.random.default_rng(seed)
    types = ["frame_dropped", "feature_error", "stage_tuning", "breaker_open"]
    return [
        {"type": types[int(rng.integers(4))], "message": f"m{int(rng.integers(3))}",
         "timestamp_s": float(rng.integers(0, 6)) * 0.5, "metadata": {"seq_id": int(rng.integers(100)), "k": [1, 2]}}
        for _ in range(12)
    ]


def _hub_report(m):
    hub = m["hub"]
    adapters = [
        hub.ControlPlaneStageAdapter(
            name, lambda name=name: {"stage": name, "state": "healthy", "timestamp_s": 9.0, "count": len(name)},
            lambda seed=seed: _stage_events(seed),
        )
        for seed, name in enumerate(("tracking", "feature", "ingestion"))
    ]
    report = hub.ControlPlaneHub(adapters[:2])
    report.register(adapters[2])
    out = report.generate_report()
    bus = hub.DeterministicEventBus(capacity=3)
    for i in range(5):
        bus.publish({"i": i})
    return out.to_dict(), out.stages, bus.drain(), bus.total_published


def test_hub_report_and_digests_equal_reference():
    ours, ref = _hub_report(MODS[PORT]), _hub_report(MODS[REF])
    assert ours == ref
    assert ours[0]["overall_digest"] and len(ours[0]["events"]) == 36


def _supervisor_run(m):
    sup_mod = m["sup"]
    clock = Clock()
    sup = sup_mod.ControlPlaneSupervisor(
        sup_mod.ControlPlaneSupervisorConfig(recovery_cooldown_s=1.0, consecutive_healthy_required=2, recovery_queue_capacity=2),
        clock=clock,
    )

    def obs(errors=0, trips=0, depth=None, state="closed"):
        snap = {"breaker_trips": trips, "breaker_state": state}
        if depth is not None:
            snap.update(entry_queue_depth=depth, entry_capacity=8)
        return snap, [{"type": "decode_error", "message": "failed"} for _ in range(errors)]

    steps = [
        {"ingestion": obs(errors=9), "feature": obs(), "tracking": obs(), "optimization": obs()},
        {"ingestion": obs(trips=1), "feature": obs(state="open"), "tracking": obs(depth=7)},
        {"ingestion": obs(), "feature": obs(), "tracking": obs()},
        {"ingestion": obs(), "feature": obs(errors=3), "tracking": obs()},
        {"ingestion": obs(), "feature": obs(), "tracking": obs(trips=3)},
        {"ingestion": obs(), "feature": obs(), "tracking": obs()},
        {"ingestion": obs(), "feature": obs(), "tracking": obs()},
    ]
    states = []
    for i, step in enumerate(steps):
        clock.now = 0.75 * i
        states.append(sup.update(step))
    tasks = [(t.severity, t.enqueued_at, t.stage, t.seq, t.reason) for t in sup.recovery_queue.drain()]
    return states, sup.transitions, sup.snapshot(), sup.digest(), sup.recovery_queue.dropped, tasks


def test_supervisor_fsm_equals_reference():
    ours, ref = _supervisor_run(MODS[PORT]), _supervisor_run(MODS[REF])
    assert ours == ref
    assert {"tripped", "degraded", "recovering", "healthy"} <= {s for st in ours[0] for s in st.values()}
    assert tsup.STAGE_DEPENDENCIES == jsup.STAGE_DEPENDENCIES


@pytest.mark.parametrize(
    "kw",
    [dict(seed=3, num_steps=50, failure_probability=0.2), dict(seed=4, num_steps=50), dict(),
     dict(seed=7, num_steps=40, stages=("feature", "tracking"), failure_probability=0.4,
          type_weights={"timeout": 1.0, "solver_stall": 3.0})],
)
def test_failure_plan_equals_reference(kw):
    ours, ref = tfi.build_failure_plan(tfi.FailureInjectionConfig(**kw)), jfi.build_failure_plan(jfi.FailureInjectionConfig(**kw))
    assert [(f.step, f.stage, f.failure_type) for f in ours.failures] == [(f.step, f.stage, f.failure_type) for f in ref.failures]
    assert ours.digest() == ref.digest()
    assert ours.failures_at(5) == [tfi.InjectedFailure(f.step, f.stage, f.failure_type) for f in ref.failures_at(5)]


def _harness(m):
    fi, hub = m["fi"], m["hub"]
    plan = fi.build_failure_plan(fi.FailureInjectionConfig(seed=1, num_steps=30, failure_probability=0.3))
    harness = fi.FailureInjectionHarness(plan)
    fired = harness.run_all()
    report = hub.ControlPlaneHub(harness.adapters()).generate_report()
    chaos = fi.FailureInjectionChaosHarness(plan, num_threads=1).run()
    return fired, report.to_dict(), [harness.stage_snapshot(s) for s in plan.config.stages], chaos


def test_failure_harness_and_chaos_digest_equal_reference():
    ours, ref = _harness(MODS[PORT]), _harness(MODS[REF])
    assert ours == ref
    assert ours[0] == len(ours[1]["events"]) > 0


# ----------------------------------------------------------------------
# Feature and tracking planes (the reference's cases, through the port)
# ----------------------------------------------------------------------

FC_KW = dict(num_features=64, max_matches=32)


def _frames(n=6, seed=0):
    """``tests/test_runtime.py``'s plane frames."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(n):
        img = rng.uniform(0, 30, size=(96, 128)).astype(np.float32)
        for _ in range(40):
            y, x, s = rng.integers(22, 68), rng.integers(22, 100), rng.integers(3, 7)
            img[y : y + s, x : x + s] = rng.uniform(140, 255)
        frames.append(img)
    return frames


def _plane(config=None, **kw):
    return tfplane.FeatureControlPlane(FeaturePipelineConfig(**FC_KW), config or tfplane.FeatureControlConfig(**kw), device="cpu")


def test_feature_plane_in_order_results():
    plane = _plane(num_workers=2, batch_size=1)
    for i, f in enumerate(_frames()):
        assert plane.submit(i, f)
    results = plane.collect(timeout=60.0)
    assert [r.seq_id for r in results] == list(range(6))
    assert all(r.ok for r in results)
    assert results[0].num_features > 5 and results[0].descriptors.dtype == np.uint32
    health = plane.health_snapshot()
    assert health["submitted"] == 6 and health["completed"] == 6 and not health["batch_mode"]
    plane.close()


def test_feature_cache_hit():
    plane = _plane(num_workers=1, batch_size=1)
    frame = _frames(1)[0]
    plane.submit(0, frame)
    plane.collect(timeout=60.0)
    plane.submit(1, frame)  # identical frame → cache
    results = plane.collect(timeout=60.0)
    assert results and results[0].from_cache
    assert plane.health_snapshot()["cache_hits"] == 1
    plane.close()


def test_batch_assembler_matches_batch_api_and_the_reference_plane():
    """Batch-mode results equal one batched extraction and the reference
    plane's results bit for bit; a partial batch (3 frames, batch 4)
    flushes on timeout."""
    frames = _frames()[:3]
    results = {}
    for name, plane in (
        (PORT, _plane(batch_size=4, flush_timeout_s=0.05)),
        (REF, jfplane.FeatureControlPlane(JFC(**FC_KW), jfplane.FeatureControlConfig(batch_size=4, flush_timeout_s=0.05))),
    ):
        for i, f in enumerate(frames):
            assert plane.submit(i, f)
        results[name] = plane.collect(timeout=60.0)
        health = plane.health_snapshot()
        assert health["batch_mode"] and health["batches"] >= 1 and health["mean_batch_fill"] <= 4.0
        plane.close()
    ours, ref = results[PORT], results[REF]
    assert [r.seq_id for r in ours] == [r.seq_id for r in ref] == [0, 1, 2]
    direct = FeaturePipeline(FeaturePipelineConfig(**FC_KW), device="cpu").detect_and_describe_batch(np.stack(frames))
    for i, (r, j) in enumerate(zip(ours, ref)):
        assert r.ok and r.num_features == j.num_features > 5
        np.testing.assert_array_equal(r.keypoints, j.keypoints)
        np.testing.assert_array_equal(r.descriptors, j.descriptors)
        np.testing.assert_array_equal(r.valid, j.valid)
        np.testing.assert_array_equal(r.keypoints, direct.xy[i].numpy())
        np.testing.assert_array_equal(r.descriptors, direct.descriptors[i].numpy().view(np.uint32))


def test_batch_assembler_error_marks_all_frames():
    plane = _plane(batch_size=2, flush_timeout_s=0.02)

    def boom(frames):
        raise RuntimeError("device fell over")

    plane._pipeline.detect_and_describe_batch = boom
    for i, f in enumerate(_frames()[:2]):
        assert plane.submit(i, f)
    results = plane.collect(timeout=30.0)
    assert len(results) == 2
    assert all(not r.ok and "device fell over" in r.error for r in results)
    assert plane.health_snapshot()["failed"] == 2
    assert any(e["type"] == "feature_error" for e in plane.stage_events())
    plane.close()


def test_batch_assembler_shape_change_starts_new_batch():
    plane = _plane(batch_size=4, flush_timeout_s=0.2)
    small = _frames(2)
    big = [np.pad(f, ((0, 32), (0, 0))) for f in _frames(2)]
    for i, f in enumerate(small + big):
        assert plane.submit(i, f)
    results = plane.collect(timeout=120.0)
    assert [r.seq_id for r in results] == [0, 1, 2, 3]
    assert all(r.ok for r in results)
    assert plane.health_snapshot()["batches"] == 2
    plane.close()


def test_warmup_seeds_the_flush_timeout():
    plane = _plane()
    assert plane.config.batch_size == 4 and plane.config.flush_timeout_s is None
    plane.warmup(_frames(1)[0])
    assert plane.health_snapshot()["flush_timeout_s_effective"] >= 0.005
    plane.close()


def test_tracking_plane_pairs_results():
    plane = _plane(num_workers=2, batch_size=1)
    tracking = ttplane.TrackingControlPlane(plane, ttplane.TrackingControlConfig(max_pending=8))
    for i, f in enumerate(_frames()):
        assert tracking.submit_frame(i, 0.1 * i, f)
    results = tracking.collect(timeout=60.0)
    assert [r.seq_id for r in results] == list(range(6))
    assert all(r.ok for r in results)
    assert tracking.health_snapshot()["completed"] == 6
    plane.close()


def test_tracking_buffer_overflow_drop_oldest():
    buf = ttplane.PendingFrameBuffer(max_pending=2, ttl_s=60.0, policy="drop_oldest")
    assert buf.add(0, 0.0, np.zeros((2, 2))) is None
    assert buf.add(1, 0.1, np.zeros((2, 2))) is None
    assert buf.add(2, 0.2, np.zeros((2, 2))) == 0  # oldest dropped
    buf_reject = ttplane.PendingFrameBuffer(max_pending=1, ttl_s=60.0, policy="reject_new")
    buf_reject.add(0, 0.0, np.zeros((2, 2)))
    assert buf_reject.add(1, 0.1, np.zeros((2, 2))) == -1
    with pytest.raises(ValueError, match="drop policy"):
        ttplane.TrackingControlConfig(drop_policy="drop_newest")


def test_pending_ttl_expiry():
    clock = [0.0]
    buf = ttplane.PendingFrameBuffer(max_pending=4, ttl_s=1.0, policy="drop_oldest", clock=lambda: clock[0])
    buf.add(0, 0.0, np.zeros((2, 2)))
    assert buf.expire() == []
    clock[0] = 2.0
    expired = buf.expire()
    assert len(expired) == 1 and expired[0].seq_id == 0


def test_tracking_plane_drops_and_events_equal_reference():
    """Scripted feature results (late ones expire, one errs, one frame is
    rejected by the feature plane) through both packages' tracking plane,
    on an injected clock: the same results, events and digest."""

    class Stub:
        """A feature plane whose results come back ``lag`` steps later."""

        def __init__(self, fmod):
            self.fmod, self.step, self.pending = fmod, 0, {}

        def submit(self, seq_id, frame):
            if seq_id == 5:
                return False
            error = "RuntimeError: boom" if seq_id == 4 else None
            result = self.fmod.FeatureResult(
                seq_id, np.zeros((1, 2)), np.zeros((1, 8), np.uint32), np.ones(1, bool), 1, error=error
            )
            self.pending[seq_id] = (seq_id + (1 if seq_id % 2 == 0 else 4), result)
            return True

        def drain_ready(self):
            out = [r for _, (due, r) in sorted(self.pending.items()) if due <= self.step]
            for r in out:
                del self.pending[r.seq_id]
            return out

    def run(mod, fmod):
        clock, stub = Clock(), Stub(fmod)
        plane = mod.TrackingControlPlane(stub, mod.TrackingControlConfig(max_pending=3, frame_ttl_s=1.0), clock=clock)
        log = []
        for i in range(10):
            stub.step, clock.now = i, 0.4 * i
            log.append(plane.submit_frame(i, 0.1 * i, np.zeros((2, 2))))
            log += [(r.seq_id, r.drop_reason, r.ok, r.wait_s) for r in plane.drain_ready()]
        return log, plane.health_snapshot(), plane.stage_events(), plane.event_digest()

    ours, ref = run(ttplane, tfplane), run(jtplane, jfplane)
    assert ours == ref
    reasons = {entry[1] for entry in ours[0] if isinstance(entry, tuple)}
    assert {None, "deadline_expired", "feature_error"} <= reasons
    assert "feature_plane_rejected" in {e["message"] for e in ours[2]}


# ----------------------------------------------------------------------
# AsyncIngestionPipeline
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def png_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(10):
        p = root / f"{i:06d}.png"
        write_png_gray(p, rng.integers(0, 256, size=(32, 48), dtype=np.uint8))
        paths.append(p)
    return paths


@pytest.mark.parametrize("process_pool", [False, True], ids=["threads", "processes"])
def test_async_ingestion_decodes_in_order(png_files, process_pool):
    pipeline = tingest.AsyncIngestionPipeline(
        png_files, config=tingest.IngestionPipelineConfig(num_workers=2, use_process_pool=process_pool)
    )
    packets = list(pipeline)
    assert [p.index for p in packets] == list(range(10))
    for p in packets:
        assert p.path == png_files[p.index]
        np.testing.assert_array_equal(p.frame, _default_read_fn(png_files[p.index]))
    report = pipeline.failure_report()
    assert (report.decoded, report.failed, report.dropped) == (10, 0, 0)
    assert pipeline.health_snapshot()["stage"] == "ingestion"
    if process_pool:
        assert pipeline._executor._processes in (None, {})  # the workers were joined


def test_injected_read_fn_rejected_with_process_pool():
    with pytest.raises(ValueError, match="read_fn"):
        tingest.AsyncIngestionPipeline(
            ["x.png"], config=tingest.IngestionPipelineConfig(use_process_pool=True), read_fn=lambda p: None
        )


def _synthetic_read_fn(path):
    if "bad" in str(path):
        return None
    rng = np.random.default_rng(int(str(path).split("_")[-1].split(".")[0]))
    return rng.integers(0, 255, size=(32, 48), dtype=np.uint8)


def test_failed_decodes_dropped_and_reported_as_the_reference():
    from mvslam_tpu.runtime.ingestion import AsyncIngestionPipeline as JPipeline
    from mvslam_tpu.runtime.ingestion import IngestionPipelineConfig as JConfig

    paths = [f"frame_{'bad_' if i in (3, 7) else ''}{i}.png" for i in range(10)]
    out = {}
    for name, cls, cfg in ((PORT, tingest.AsyncIngestionPipeline, tingest.IngestionPipelineConfig), (REF, JPipeline, JConfig)):
        pipeline = cls(paths, config=cfg(num_workers=2), read_fn=_synthetic_read_fn)
        packets = list(pipeline)
        out[name] = ([p.index for p in packets], [p.frame.tobytes() for p in packets], pipeline.failure_report().to_dict())
    assert out[PORT] == out[REF]
    assert out[PORT][0] == [0, 1, 2, 4, 5, 6, 8, 9] and out[PORT][2]["retries"] == 4


# ----------------------------------------------------------------------
# SLAMSystem.run_stream_async and the runner's async mode
# ----------------------------------------------------------------------


def _shifting_scene(num=5, h=96, w=160, shift=4):
    """``tests/test_runtime.py``'s run_stream_async scene."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 30, size=(h, w + shift * num)).astype(np.float32)
    for _ in range(80):
        y, x, s = rng.integers(22, h - 28), rng.integers(22, base.shape[1] - 28), rng.integers(3, 7)
        base[y : y + s, x : x + s] = rng.uniform(140, 255)
    return [base[:, i * shift : i * shift + w].copy() for i in range(num)]


def _rendered_scene(num=5):
    """A small rendered 3-D scene: E and H are both well posed, so the
    packages' E/H choices agree."""
    from mvslam_tpu_torch.data.synthetic import render_scene

    frames, _, intrinsics, _ = render_scene(num_frames=num, h=96, w=160, seed=0, n_pts=200)
    return [np.asarray(f) for f in frames], intrinsics


def _async_config(api, root, run_id, intrinsics=(100.0, 100.0, 80.0, 48.0), **kw):
    FC, PC, KC = (FeaturePipelineConfig, RobustPoseEstimatorConfig, KeyframeConfig) if api is tapi else (JFC, JPC, JKC)
    fx, fy, cx, cy = intrinsics
    return api.SLAMSystemConfig(
        run_id=run_id, output_root=root, seed=1, fx=fx, fy=fy, cx=cx, cy=cy,
        feature=FC(num_features=128, max_matches=64), pose=PC(num_hypotheses=64), keyframe=KC(min_translation=0.05), **kw,
    )


@pytest.mark.parametrize("scene", ["sliding_plane", "rendered"])
def test_run_stream_async_equals_reference(tmp_path, scene):
    """``run_stream_async`` in both packages (window BA off: it is held to
    the reference by ``test_torch_ba.py``). On the reference's own scene, a
    textured plane sliding sideways, the essential matrix is degenerate:
    whether its RANSAC succeeds is set by f32 rounding in either package
    (ROADMAP Queue 3), so the E/H choice there is not compared. On a
    rendered 3-D scene it is held on >= 80% of the frames."""
    if scene == "sliding_plane":
        frames, intrinsics = _shifting_scene(num=5), (100.0, 100.0, 80.0, 48.0)
    else:
        frames, intrinsics = _rendered_scene()
    ttl = dict(frame_ttl_s=120.0)
    port = tapi.SLAMSystem(_async_config(tapi, tmp_path, "async", intrinsics, enable_local_ba=False), device="cpu")
    diags = port.run_stream_async(packets_from_arrays(frames), tracking_control_config=ttplane.TrackingControlConfig(**ttl))
    ref = japi.SLAMSystem(_async_config(japi, tmp_path, "ref", intrinsics, enable_local_ba=False))
    ref_diags = ref.run_stream_async(jpackets(frames), tracking_control_config=jtplane.TrackingControlConfig(**ttl))

    assert [d.frame_id for d in diags] == [d.frame_id for d in ref_diags] == list(range(5))
    assert diags[0].model_type == ref_diags[0].model_type == "bootstrap"
    assert [d.failure_reason for d in diags] == [d.failure_reason for d in ref_diags]
    assert [d.num_features for d in diags] == [d.num_features for d in ref_diags]
    assert [d.num_matches for d in diags] == [d.num_matches for d in ref_diags]
    assert sum(d.pose_success for d in diags[1:]) >= 3
    if scene == "rendered":
        agree = np.mean([d.model_type == r.model_type for d, r in zip(diags, ref_diags)])
        assert agree >= 0.8, [(d.model_type, r.model_type) for d, r in zip(diags, ref_diags)]
    report, ref_report = (s.store.load_report("control_plane_report") for s in (port, ref))
    assert set(report["snapshots"]) == set(ref_report["snapshots"]) == {"feature", "tracking"}
    for stage in ("feature", "tracking"):
        assert report["snapshots"][stage].keys() == ref_report["snapshots"][stage].keys()
    assert report["snapshots"]["feature"]["failed"] == 0 and report["snapshots"]["tracking"]["dropped"] == 0
    assert report["event_digest"] == ref_report["event_digest"] and not report["events"]
    assert port.finalize_run().num_frames == 5


def test_run_stream_async_equals_process_frame(tmp_path):
    """At the default system configuration (window BA, relocalization and
    snapshots on), the async path and ``process_frame`` over the same
    frames give the same trajectory and diagnostics, bit for bit."""
    frames = _shifting_scene(num=6)
    system = tapi.SLAMSystem(_async_config(tapi, tmp_path, "async"), device="cpu")
    assert system.config.enable_local_ba and system.config.enable_relocalization and system.config.persist_map_snapshot
    diags = system.run_stream_async(
        packets_from_arrays(frames), tracking_control_config=ttplane.TrackingControlConfig(frame_ttl_s=120.0)
    )
    single = tapi.SLAMSystem(_async_config(tapi, tmp_path, "single"), device="cpu")
    single_diags = [single.process_frame(f, float(i)) for i, f in enumerate(frames)]
    assert sum(d.is_keyframe for d in diags) >= 2
    assert np.array_equal(np.stack(system.trajectory.poses), np.stack(single.trajectory.poses))
    strip = lambda d: {k: v for k, v in d.to_dict().items() if k != "correlation_id"}  # noqa: E731
    assert [strip(d) for d in diags] == [strip(d) for d in single_diags]


def test_run_stream_async_warm_failure_raises(tmp_path, monkeypatch):
    """A kernel that fails in the warm step (before any frame is queued)
    fails the call; the control-plane report is still written."""
    system = tapi.SLAMSystem(_async_config(tapi, tmp_path, "warm"), device="cpu")

    def broken(self, frames):
        raise RuntimeError("kernel failed to build")

    monkeypatch.setattr(FeaturePipeline, "detect_and_describe_batch", broken)
    with pytest.raises(RuntimeError, match="failed to build"):
        system.run_stream_async(packets_from_arrays(_shifting_scene(num=2)))
    assert set(system.store.load_report("control_plane_report")["snapshots"]) == {"feature", "tracking"}


def test_run_stream_async_reports_feature_errors(tmp_path, monkeypatch):
    """Extraction that fails on the assembler thread: each frame ends as a
    ``feature_error`` failure, the report counts and names them."""
    system = tapi.SLAMSystem(_async_config(tapi, tmp_path, "broken"), device="cpu")

    def broken(self, frames):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(tfplane.FeatureControlPlane, "warmup", lambda self, frame: None)
    monkeypatch.setattr(FeaturePipeline, "detect_and_describe_batch", broken)
    diags = system.run_stream_async(
        packets_from_arrays(_shifting_scene(num=3)),
        tracking_control_config=ttplane.TrackingControlConfig(frame_ttl_s=120.0),
    )
    assert [d.failure_reason for d in diags] == ["feature_error"] * 3
    assert not any(d.pose_success for d in diags)
    report = system.store.load_report("control_plane_report")
    assert report["snapshots"]["feature"]["failed"] == 3
    assert any("kernel failed" in e["message"] for e in report["events"])


def test_runner_async_equals_stream(tmp_path):
    from mvslam_tpu_torch.data.synthetic import write_kitti_sequence
    from mvslam_tpu_torch.slam import runner

    frames = [f.astype(np.uint8) for f in _shifting_scene(num=6)]
    root, _ = write_kitti_sequence(tmp_path / "kitti", frames, np.zeros((6, 3)), (100.0, 100.0, 80.0, 48.0))
    runs = {}
    for mode in ("stream", "async"):
        result = runner.run_kitti_sequence(root, run_id=mode, output_root=tmp_path / "runs", seed=1, ingestion=mode,
                                           window=2, device="cpu")
        runs[mode] = result
    a, b = (np.load(runs[m].trajectory_path) for m in ("stream", "async"))
    assert sorted(a.files) == sorted(b.files) and all(np.array_equal(a[k], b[k]) for k in a.files)

    def diagnostics(mode):
        records = json.loads((runs[mode].run_dir / "diagnostics" / "frame_diagnostics.json").read_text())
        return [{k: v for k, v in d.items() if k != "correlation_id"} for d in records]

    assert diagnostics("stream") == diagnostics("async")
    assert sum(d["pose_success"] for d in diagnostics("async")) >= 3
    report = RunDataStore(runs["async"].run_dir).load_report("ingestion_report")
    assert (report["decoded"], report["failed"], report["dropped"]) == (6, 0, 0)


def test_new_modules_leave_jax_out():
    """Importing the runtime modules, the front end and the runner brings in
    neither jax nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    modules = ["mvslam_tpu_torch.runtime." + m for m in (
        "ingestion_control", "hub", "supervisor", "failure_injection", "feature_plane", "tracking_plane", "ingestion")]
    modules += ["mvslam_tpu_torch.frontend", "mvslam_tpu_torch.frontend.intrinsics", "mvslam_tpu_torch.slam.runner"]
    code = (
        f"import sys, importlib; [importlib.import_module(m) for m in {modules!r}]; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'mvslam_tpu.'))]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
