"""Tracking control plane: order async feature results for the tracker.

Port of ``mvslam_tpu/runtime/tracking_plane.py`` (pure host code over
the port's ``FeatureControlPlane``). Parity: reference ``tracking_control_plane.py`` — a ``PendingFrameBuffer``
with TTL deadlines (heap) and drop policies drop_oldest / reject_new (ref
L187-239), pairing of in-order feature results with their pending frames
into ``TrackingFrameResult`` records (ref L242-252), drop events
(buffer_overflow / deadline_expired / circuit_breaker_open, ref L305-357),
a breaker recording feature errors (ref L372-377), and telemetry + event
log + health snapshot (ref L419-450).
"""

from __future__ import annotations

import heapq
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from mvslam_tpu_torch.core.integrity import stable_event_digest
from mvslam_tpu_torch.core.persistence import StreamingMoments
from mvslam_tpu_torch.runtime.feature_plane import FeatureControlPlane, FeatureResult
from mvslam_tpu_torch.runtime.ingestion_control import (
    CircuitBreaker,
    CircuitBreakerConfig,
    DeterministicEventLog,
)


@dataclass(frozen=True)
class TrackingControlConfig:
    """Parity: ``tracking_control_plane.py:22-48``."""

    max_pending: int = 16
    frame_ttl_s: float = 5.0
    drop_policy: str = "drop_oldest"  # "drop_oldest" | "reject_new"
    breaker: CircuitBreakerConfig = CircuitBreakerConfig()

    def __post_init__(self):
        if self.drop_policy not in ("drop_oldest", "reject_new"):
            raise ValueError(f"unknown drop policy {self.drop_policy!r}")


@dataclass
class PendingFrame:
    seq_id: int
    timestamp: float
    frame: np.ndarray
    deadline: float
    submitted_at: float


@dataclass
class TrackingFrameResult:
    """Parity: ``tracking_control_plane.py:242-252``."""

    seq_id: int
    timestamp: float
    frame: Optional[np.ndarray]
    feature_result: Optional[FeatureResult]
    drop_reason: Optional[str] = None
    wait_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.drop_reason is None and self.feature_result is not None and self.feature_result.ok


class PendingFrameBuffer:
    """TTL'd pending-frame store with deterministic drop policies.

    Parity: ``tracking_control_plane.py:187-239``.
    """

    def __init__(self, max_pending: int, ttl_s: float, policy: str, clock=time.monotonic) -> None:
        self.max_pending = max_pending
        self.ttl_s = ttl_s
        self.policy = policy
        self._clock = clock
        self._frames: Dict[int, PendingFrame] = {}
        self._deadline_heap: List[tuple] = []
        self._lock = threading.Lock()

    def add(self, seq_id: int, timestamp: float, frame: np.ndarray) -> Optional[int]:
        """Add a frame; returns the seq_id of a dropped frame (policy
        drop_oldest), −1 when the new frame is rejected, None otherwise."""
        now = self._clock()
        with self._lock:
            dropped: Optional[int] = None
            if len(self._frames) >= self.max_pending:
                if self.policy == "reject_new":
                    return -1
                oldest = min(self._frames, key=lambda s: (self._frames[s].submitted_at, s))
                del self._frames[oldest]
                dropped = oldest
            entry = PendingFrame(
                seq_id=seq_id,
                timestamp=timestamp,
                frame=frame,
                deadline=now + self.ttl_s,
                submitted_at=now,
            )
            self._frames[seq_id] = entry
            heapq.heappush(self._deadline_heap, (entry.deadline, seq_id))
            return dropped

    def pop(self, seq_id: int) -> Optional[PendingFrame]:
        with self._lock:
            return self._frames.pop(seq_id, None)

    def expire(self) -> List[PendingFrame]:
        now = self._clock()
        expired: List[PendingFrame] = []
        with self._lock:
            while self._deadline_heap and self._deadline_heap[0][0] <= now:
                _, seq_id = heapq.heappop(self._deadline_heap)
                entry = self._frames.pop(seq_id, None)
                if entry is not None:
                    expired.append(entry)
        return expired

    def __len__(self) -> int:
        with self._lock:
            return len(self._frames)


class TrackingControlPlane:
    """Pairs ordered feature results with pending frames for the tracker.

    Parity: ``tracking_control_plane.py:255-453``.
    """

    def __init__(
        self,
        feature_plane: FeatureControlPlane,
        config: Optional[TrackingControlConfig] = None,
        clock=time.monotonic,
    ) -> None:
        self.config = config or TrackingControlConfig()
        self.feature_plane = feature_plane
        self.clock = clock
        self.pending = PendingFrameBuffer(
            self.config.max_pending, self.config.frame_ttl_s, self.config.drop_policy, clock
        )
        self.breaker = CircuitBreaker(self.config.breaker, clock=clock)
        self.events = DeterministicEventLog(clock=clock)
        self._wait_stats = StreamingMoments()
        self.submitted = 0
        self.dropped = 0
        self.completed = 0

    def submit_frame(self, seq_id: int, timestamp: float, frame: np.ndarray) -> bool:
        """Parity: ``tracking_control_plane.py:326``."""
        if not self.breaker.allow():
            self.dropped += 1
            self.events.emit(
                "frame_dropped", message="circuit_breaker_open", seq_id=seq_id
            )
            return False
        dropped = self.pending.add(seq_id, timestamp, np.asarray(frame))
        if dropped == -1:
            self.dropped += 1
            self.events.emit("frame_dropped", message="buffer_overflow_reject", seq_id=seq_id)
            return False
        if dropped is not None:
            self.dropped += 1
            self.events.emit("frame_dropped", message="buffer_overflow", seq_id=dropped)
        accepted = self.feature_plane.submit(seq_id, frame)
        if not accepted:
            self.pending.pop(seq_id)
            self.dropped += 1
            self.events.emit("frame_dropped", message="feature_plane_rejected", seq_id=seq_id)
            return False
        self.submitted += 1
        return True

    def drain_ready(self) -> List[TrackingFrameResult]:
        """Expire TTLs, collect in-order feature results, pair with frames.

        Parity: ``tracking_control_plane.py:392-397``.
        """
        out: List[TrackingFrameResult] = []
        for entry in self.pending.expire():
            self.dropped += 1
            self.events.emit("frame_dropped", message="deadline_expired", seq_id=entry.seq_id)
            out.append(
                TrackingFrameResult(
                    seq_id=entry.seq_id,
                    timestamp=entry.timestamp,
                    frame=None,
                    feature_result=None,
                    drop_reason="deadline_expired",
                )
            )
        now = self.clock()
        for feature_result in self.feature_plane.drain_ready():
            entry = self.pending.pop(feature_result.seq_id)
            if entry is None:
                continue  # was dropped while features computed
            if not feature_result.ok:
                self.breaker.record_failure()
                self.events.emit(
                    "feature_error", message=feature_result.error or "", seq_id=feature_result.seq_id
                )
                out.append(
                    TrackingFrameResult(
                        seq_id=entry.seq_id,
                        timestamp=entry.timestamp,
                        frame=entry.frame,
                        feature_result=feature_result,
                        drop_reason="feature_error",
                    )
                )
                continue
            self.breaker.record_success()
            self.completed += 1
            wait = now - entry.submitted_at
            self._wait_stats.update(wait)
            out.append(
                TrackingFrameResult(
                    seq_id=entry.seq_id,
                    timestamp=entry.timestamp,
                    frame=entry.frame,
                    feature_result=feature_result,
                    wait_s=wait,
                )
            )
        return out

    def collect(self, timeout: float = 30.0) -> List[TrackingFrameResult]:
        """Drain until the pending buffer empties.

        ``timeout`` bounds time *without progress* (each drained result
        resets the deadline) so a slow first kernel build in the feature
        workers doesn't abandon in-flight frames; only a stuck pipeline
        trips it.
        """
        deadline = time.monotonic() + timeout
        out: List[TrackingFrameResult] = []
        while time.monotonic() < deadline:
            drained = self.drain_ready()
            if drained:
                out.extend(drained)
                deadline = time.monotonic() + timeout
            if len(self.pending) == 0:
                break
            time.sleep(0.002)
        return out

    def health_snapshot(self) -> Dict[str, Any]:
        """Parity: ``tracking_control_plane.py:419-450``."""
        return {
            "stage": "tracking",
            "state": "tripped" if self.breaker.state == "open" else "healthy",
            "submitted": self.submitted,
            "completed": self.completed,
            "dropped": self.dropped,
            "pending": len(self.pending),
            "breaker_state": self.breaker.state,
            "breaker_trips": self.breaker.trip_count,
            "wait": self._wait_stats.summary(),
        }

    def stage_events(self) -> List[Dict[str, Any]]:
        return self.events.events()

    def event_digest(self) -> str:
        return stable_event_digest(self.events.events())
