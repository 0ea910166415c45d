"""Supervised async feature extraction control plane.

Port of ``mvslam_tpu/runtime/feature_plane.py``. Parity: reference
``feature_control_plane.py`` — frames are submitted to a thread-pool of
workers running the feature pipeline, with a per-frame deterministic seed
``base + seq_id`` (ref L292, L504), a blake2b frame-hash keyed LRU+TTL
feature cache (ref L188-245), an inflight semaphore for backpressure (ref
L351, L399), a dict-based reorder buffer (ref L219-237), a circuit
breaker, P²-quantile latency telemetry (ref L117-185), and a health
snapshot + event digest (ref L590-631).

Device: the plane runs its :class:`FeaturePipeline` on ``device``
(default ``"cuda"``). On one card, per-frame worker threads serialise at
launch; the data-parallel axis is the BATCH: with ``batch_size > 1`` a
device-batch assembler thread stacks submitted frames and runs ONE batched
detect+describe per batch (kernels K1 and K2 launch once for all of its
frames; a partial batch is padded to ``batch_size`` so every batch has one
shape, and flushes on a timeout for a latency bound), while cache
probing and hashing stay on the caller's thread. ``batch_size = 1`` keeps
the thread-pool path. The assembler launches on the device's default
stream, the stream the caller's thread uses for matching and pose, so
the two threads' work is ordered on the card without events.

An exception during extraction becomes ``feature_error`` results, an
event and a breaker count, as in the reference: a caller that must not
lose frames checks the results and the events.

Given the system's telemetry recorder, the plane records per frame
``feature_queue`` (from ``submit`` to the start of its extraction) and per
batch ``feature_batch`` (frame ids and fill) on its own thread, and stamps
each result with the moment it was ready (``FeatureResult.ready_s``), all
on the recorder's clock.

Process isolation: the reference's ProcessPoolExecutor feature workers
(``feature_control_plane.py:248-319``) are not reproduced, as in the JAX
package: a worker process would need a CUDA context of its own on the
same card. Fault isolation for host-side decode lives in the ingestion
process pool (``runtime/ingestion.py``).
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from mvslam_tpu_torch.core.integrity import stable_event_digest
from mvslam_tpu_torch.core.persistence import StreamingMoments
from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder, timed_event
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipeline, FeaturePipelineConfig, FeatureSet
from mvslam_tpu_torch.runtime.ingestion_control import (
    CircuitBreaker,
    CircuitBreakerConfig,
    DeterministicEventLog,
)
from mvslam_tpu_torch.slam.tracking import _pack_features, unpack_features


@dataclass(frozen=True)
class FeatureControlConfig:
    """Parity: ``feature_control_plane.py:30-61``.

    ``batch_size > 1`` enables the device-batch assembler: up to
    ``batch_size`` submitted frames are stacked and extracted by ONE
    batched detect+describe; a partial batch flushes after the flush
    timeout so latency stays bounded. ``batch_size = 1`` uses per-frame thread-pool workers
    (the reference's shape, kept for comparison).

    ``flush_timeout_s = None`` (the default) makes the flush timeout
    ADAPTIVE: an EMA of measured per-batch dispatch walls (floor 5 ms,
    cap 250 ms). Rationale: the useful wait is "about one dispatch" —
    while the device runs batch *i*, the producer has exactly that long
    to fill batch *i+1*. A float pins the timeout.
    """

    num_workers: int = 2
    max_inflight: int = 8
    cache_capacity: int = 64
    cache_ttl_s: float = 30.0
    breaker: CircuitBreakerConfig = CircuitBreakerConfig()
    base_seed: int = 0
    batch_size: int = 4
    flush_timeout_s: Optional[float] = None


_FLUSH_FLOOR_S = 0.005
_FLUSH_CAP_S = 0.25


@dataclass
class FeatureResult:
    """Parity: ``feature_control_plane.py:89-101``."""

    seq_id: int
    keypoints: np.ndarray  # (N, 2)
    descriptors: np.ndarray  # (N, 8) uint32, the bits of the port's int32 words
    valid: np.ndarray  # (N,)
    num_features: int
    from_cache: bool = False
    error: Optional[str] = None
    ready_s: Optional[float] = field(default=None, compare=False)  # the recorder's clock

    @property
    def ok(self) -> bool:
        return self.error is None


class _LruTtlCache:
    """blake2b frame-hash keyed feature cache. Parity: ref L188-245."""

    def __init__(self, capacity: int, ttl_s: float, clock=time.monotonic) -> None:
        self.capacity = capacity
        self.ttl_s = ttl_s
        self._clock = clock
        self._items: "OrderedDict[str, Tuple[float, Any]]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key_for(frame: np.ndarray) -> str:
        h = hashlib.blake2b(digest_size=16)
        h.update(str(frame.shape).encode())
        h.update(np.ascontiguousarray(frame).tobytes())
        return h.hexdigest()

    def get(self, key: str):
        with self._lock:
            entry = self._items.get(key)
            if entry is None:
                self.misses += 1
                return None
            ts, value = entry
            if self._clock() - ts > self.ttl_s:
                del self._items[key]
                self.misses += 1
                return None
            self._items.move_to_end(key)
            self.hits += 1
            return value

    def put(self, key: str, value: Any) -> None:
        with self._lock:
            self._items[key] = (self._clock(), value)
            self._items.move_to_end(key)
            while len(self._items) > self.capacity:
                self._items.popitem(last=False)


@dataclass
class _PendingItem:
    """A submitted frame waiting in the device-batch assembler queue."""

    seq_id: int
    frame: np.ndarray
    cache_key: str
    future: Future
    submitted_s: Optional[float] = None  # the recorder's clock


_ASSEMBLER_STOP = object()


class FeatureControlPlane:
    """submit → collect/drain supervised async feature extraction.

    Parity: ``feature_control_plane.py:322-631``.
    """

    def __init__(
        self,
        feature_config: Optional[FeaturePipelineConfig] = None,
        config: Optional[FeatureControlConfig] = None,
        clock=time.monotonic,
        device="cuda",
        recorder: Optional[RunTelemetryRecorder] = None,
    ) -> None:
        self.config = config or FeatureControlConfig()
        self._recorder = recorder
        self.feature_config = feature_config or FeaturePipelineConfig()
        self._pipeline = FeaturePipeline(self.feature_config, device=device)
        self.device = self._pipeline.device
        self._batch_mode = self.config.batch_size > 1
        if self._batch_mode:
            self._executor = None
            self._batch_queue: "queue.Queue[Any]" = queue.Queue()
            self._assembler = threading.Thread(
                target=self._run_assembler, name="feature-batch-assembler", daemon=True
            )
            self._assembler.start()
        else:
            self._executor = ThreadPoolExecutor(
                max_workers=self.config.num_workers, thread_name_prefix="feature-worker"
            )
        self._inflight = threading.Semaphore(self.config.max_inflight)
        self._cache = _LruTtlCache(self.config.cache_capacity, self.config.cache_ttl_s, clock)
        self.breaker = CircuitBreaker(self.config.breaker, clock=clock)
        self.events = DeterministicEventLog(clock=clock)
        self._futures: Dict[int, Future] = {}
        self._ready: Dict[int, FeatureResult] = {}  # dict-based reorder (ref L219-237)
        self._next_seq_out = 0
        self._lock = threading.Lock()
        self._latency = StreamingMoments()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self.batches = 0
        self.batch_frames = 0
        # Adaptive flush state: EMA of per-batch dispatch walls + achieved
        # batch-fill histogram. Seeded at the floor so
        # the first batch flushes promptly; warmup()/the first dispatch
        # pull the EMA toward the real latency.
        self._dispatch_ema_s = _FLUSH_FLOOR_S
        self.batch_fill_counts = [0] * max(1, self.config.batch_size)
        self._closed = False

    def warmup(self, frame: np.ndarray) -> None:
        """Build the kernels and run extraction once at this frame shape,
        blocking, before any ``submit``.

        The first call builds the CUDA kernels (nvcc, seconds). Running it
        in the caller's thread first keeps downstream TTLs
        (``TrackingControlConfig.frame_ttl_s``) measuring stream staleness
        rather than build latency.
        """
        frame = np.asarray(frame)
        if self._batch_mode:
            stacked = np.broadcast_to(frame, (self.config.batch_size, *frame.shape))
            self._pipeline.detect_and_describe_batch(stacked)
            self._synchronize()
            # Seed the adaptive-flush EMA with a measured WARM batch (the
            # build above would skew it by orders of magnitude).
            start = time.perf_counter()
            self._pipeline.detect_and_describe_batch(stacked)
            self._synchronize()
            self._dispatch_ema_s = time.perf_counter() - start
        else:
            self._pipeline.detect_and_describe(frame)
            self._synchronize()

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @staticmethod
    def _host_features(feats: FeatureSet):
        """(xy, descriptors uint32, valid) numpy arrays, in ONE device-to-host copy."""
        return unpack_features(_pack_features(feats).cpu().numpy())

    # -- worker ----------------------------------------------------------

    def _now(self) -> Optional[float]:
        return None if self._recorder is None else self._recorder.now()

    def _queued(self, seq_id: int, submitted_s: Optional[float]) -> None:
        if self._recorder is not None and submitted_s is not None:
            self._recorder.span("feature_queue", submitted_s, self._recorder.now(), {"frame_id": seq_id})

    def _extract(self, seq_id: int, frame: np.ndarray, cache_key: str, submitted_s=None) -> FeatureResult:
        self._queued(seq_id, submitted_s)
        start = time.perf_counter()
        try:
            with timed_event(self._recorder, "feature_batch", metadata={"frame_ids": [seq_id], "fill": 1}):
                xy, desc, valid = self._host_features(self._pipeline.detect_and_describe(frame))
            result = FeatureResult(
                seq_id=seq_id,
                keypoints=xy,
                descriptors=desc,
                valid=valid,
                num_features=int(valid.sum()),
                ready_s=self._now(),
            )
            self._cache.put(cache_key, result)
            self.breaker.record_success()
            return result
        except Exception as exc:
            self.breaker.record_failure()
            self.events.emit("feature_error", message=str(exc), seq_id=seq_id)
            return FeatureResult(
                seq_id=seq_id,
                keypoints=np.zeros((0, 2), np.float32),
                descriptors=np.zeros((0, 8), np.uint32),
                valid=np.zeros(0, bool),
                num_features=0,
                error=f"{type(exc).__name__}: {exc}",
                ready_s=self._now(),
            )
        finally:
            self._latency.update(time.perf_counter() - start)
            self._inflight.release()

    # -- device-batch assembler (the data-parallel axis) --------------------

    def _run_assembler(self) -> None:
        """Accumulate up to ``batch_size`` frames, run ONE batched extraction.

        Flush policy: a batch launches as soon as it is full, when the
        flush timeout elapses after its first frame arrived (latency
        bound), or when the next frame's shape differs (it starts the next
        batch). The timeout is adaptive by default — ~one measured dispatch
        latency (see :meth:`_flush_timeout_s`). Replaces the reference's
        per-frame thread-pool workers (``feature_control_plane.py:283-319``)
        with the device batch axis.
        """
        carry: Optional[_PendingItem] = None
        while True:
            if carry is not None:
                item, carry = carry, None
            else:
                try:
                    item = self._batch_queue.get(timeout=0.05)
                except queue.Empty:
                    continue
            if item is _ASSEMBLER_STOP:
                return
            batch = [item]
            deadline = time.monotonic() + self._flush_timeout_s()
            stop = False
            while len(batch) < self.config.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._batch_queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _ASSEMBLER_STOP:
                    stop = True
                    break
                if nxt.frame.shape != batch[0].frame.shape:
                    carry = nxt  # starts the next batch
                    break
                batch.append(nxt)
            for it in batch:
                self._queued(it.seq_id, it.submitted_s)
            meta = {"frame_ids": [it.seq_id for it in batch], "fill": len(batch)}
            with timed_event(self._recorder, "feature_batch", metadata=meta):
                self._extract_batch(batch)
            if stop:
                return

    def _flush_timeout_s(self) -> float:
        """Partial-batch flush timeout: configured value, or ~one measured
        dispatch latency (EMA, floored/capped) when adaptive (r3 item 8)."""
        if self.config.flush_timeout_s is not None:
            return self.config.flush_timeout_s
        return min(max(self._dispatch_ema_s, _FLUSH_FLOOR_S), _FLUSH_CAP_S)

    def _extract_batch(self, batch: List[_PendingItem]) -> None:
        start = time.perf_counter()
        size = self.config.batch_size
        try:
            frames = np.stack([it.frame for it in batch])
            if len(batch) < size:
                # Pad to the batch shape (one kernel shape whatever the
                # fill); padded rows are discarded.
                pad = np.broadcast_to(frames[-1:], (size - len(batch), *frames.shape[1:]))
                frames = np.concatenate([frames, pad])
            xy, desc, valid = self._host_features(self._pipeline.detect_and_describe_batch(frames))
            for i, it in enumerate(batch):
                result = FeatureResult(
                    seq_id=it.seq_id,
                    keypoints=xy[i],
                    descriptors=desc[i],
                    valid=valid[i],
                    num_features=int(valid[i].sum()),
                    ready_s=self._now(),
                )
                self._cache.put(it.cache_key, result)
                it.future.set_result(result)
            self.breaker.record_success()
            self.batches += 1
            self.batch_frames += len(batch)
        except Exception as exc:
            self.breaker.record_failure()
            self.events.emit(
                "feature_error",
                message=str(exc),
                seq_ids=[it.seq_id for it in batch],
            )
            for it in batch:
                it.future.set_result(
                    FeatureResult(
                        seq_id=it.seq_id,
                        keypoints=np.zeros((0, 2), np.float32),
                        descriptors=np.zeros((0, 8), np.uint32),
                        valid=np.zeros(0, bool),
                        num_features=0,
                        error=f"{type(exc).__name__}: {exc}",
                        ready_s=self._now(),
                    )
                )
        finally:
            elapsed = time.perf_counter() - start
            # EMA of dispatch walls feeds the adaptive flush timeout.
            self._dispatch_ema_s = 0.7 * self._dispatch_ema_s + 0.3 * elapsed
            self.batch_fill_counts[min(len(batch), len(self.batch_fill_counts)) - 1] += 1
            for it in batch:
                self._latency.update(elapsed)
                self._inflight.release()

    # -- public ------------------------------------------------------------

    def submit(self, seq_id: int, frame: np.ndarray, timeout: Optional[float] = 5.0) -> bool:
        """Submit a frame; returns False when rejected (breaker/backpressure).

        Parity: ``feature_control_plane.py:396-469``.
        """
        if self._closed:
            raise RuntimeError("control plane closed")
        submitted_s = self._now()
        if not self.breaker.allow():
            self.rejected += 1
            self.events.emit("submit_rejected", message="circuit_breaker_open", seq_id=seq_id)
            return False
        frame = np.asarray(frame)
        cache_key = _LruTtlCache.key_for(frame)
        cached = self._cache.get(cache_key)
        if cached is not None:
            with self._lock:
                self._ready[seq_id] = FeatureResult(
                    seq_id=seq_id,
                    keypoints=cached.keypoints,
                    descriptors=cached.descriptors,
                    valid=cached.valid,
                    num_features=cached.num_features,
                    from_cache=True,
                    ready_s=self._now(),
                )
            self.submitted += 1
            self.completed += 1
            return True
        if not self._inflight.acquire(timeout=timeout):
            self.rejected += 1
            self.events.emit("submit_rejected", message="backpressure", seq_id=seq_id)
            return False
        if self._batch_mode:
            future: Future = Future()
            with self._lock:
                self._futures[seq_id] = future
            self._batch_queue.put(_PendingItem(seq_id, frame, cache_key, future, submitted_s))
        else:
            future = self._executor.submit(self._extract, seq_id, frame, cache_key, submitted_s)
            with self._lock:
                self._futures[seq_id] = future
        self.submitted += 1
        return True

    def _harvest_locked(self) -> None:
        done = [s for s, f in self._futures.items() if f.done()]
        for seq in done:
            future = self._futures.pop(seq)
            result = future.result()
            if result.error is None:
                self.completed += 1
            else:
                self.failed += 1
            self._ready[seq] = result

    def drain_ready(self) -> List[FeatureResult]:
        """In-order completed results (dict-based next-seq reorder)."""
        out: List[FeatureResult] = []
        with self._lock:
            self._harvest_locked()
            while self._next_seq_out in self._ready:
                out.append(self._ready.pop(self._next_seq_out))
                self._next_seq_out += 1
        return out

    def collect(self, timeout: float = 30.0) -> List[FeatureResult]:
        """Block until every submitted frame has been returned in order.

        ``timeout`` bounds time *without progress*, not total time: each
        drained result resets the deadline. A first kernel build inside a
        worker thread can legitimately take tens of seconds on a loaded
        host; only a genuinely stuck pipeline should trip the deadline.
        Parity: ``feature_control_plane.py`` collect/drain.
        """
        deadline = time.monotonic() + timeout
        out: List[FeatureResult] = []
        while time.monotonic() < deadline:
            drained = self.drain_ready()
            if drained:
                out.extend(drained)
                deadline = time.monotonic() + timeout
            with self._lock:
                pending = bool(self._futures) or bool(self._ready)
            if not pending:
                break
            time.sleep(0.002)
        return out

    def close(self) -> None:
        self._closed = True
        if self._batch_mode:
            self._batch_queue.put(_ASSEMBLER_STOP)
            self._assembler.join(timeout=60.0)
        else:
            self._executor.shutdown(wait=True, cancel_futures=False)

    # -- observability -------------------------------------------------------

    def health_snapshot(self) -> Dict[str, Any]:
        with self._lock:
            inflight = len(self._futures)
        return {
            "stage": "feature",
            "state": "tripped" if self.breaker.state == "open" else "healthy",
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "rejected": self.rejected,
            "inflight": inflight,
            "cache_hits": self._cache.hits,
            "cache_misses": self._cache.misses,
            "breaker_state": self.breaker.state,
            "breaker_trips": self.breaker.trip_count,
            "batch_mode": self._batch_mode,
            "batches": self.batches,
            "mean_batch_fill": (self.batch_frames / self.batches) if self.batches else 0.0,
            "batch_fill_histogram": list(self.batch_fill_counts),
            "flush_timeout_s_effective": self._flush_timeout_s(),
            "latency": self._latency.summary(),
        }

    def stage_events(self) -> List[Dict[str, Any]]:
        return self.events.events()

    def event_digest(self) -> str:
        return stable_event_digest(self.events.events())
