"""Ingestion control-plane primitives: queues, breakers, reorder buffers,
worker pools, stage supervision.

Port of ``mvslam_tpu/runtime/ingestion_control.py`` (pure host code, the
same classes, fields and behaviour; every clock injectable). The
reference's own sources: ``ingestion_control_plane.py`` —
``AdaptiveBoundedQueue`` (resizable, condition-variable, ref L49-133),
tuning config dataclasses (ref L136-182), ``DeterministicEventLog`` ring
buffer (ref L207-236), ``IngestionFailureReport`` (ref L250-262),
``CircuitBreaker`` closed/open/half-open (ref L348-395),
``DeterministicReorderBuffer`` heap with forced-flush ratio (ref
L398-445), ``DynamicWorkerPool`` (ref L448-489), EMA ``MovingAverage``
(ref L492-510), ``StageSupervisor.tick`` queue/worker tuning (ref
L513-627), and a ``ControlPlaneOrchestrator`` loop (ref L630-662).

They are host-side structures around the host→device dispatch boundary.
"""

from __future__ import annotations

import heapq
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------
# Configs (parity: ingestion_control_plane.py:136-182)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QueueTuningConfig:
    min_capacity: int = 2
    max_capacity: int = 64
    grow_threshold: float = 0.8  # depth ratio above which to grow
    shrink_threshold: float = 0.2
    grow_factor: float = 2.0


@dataclass(frozen=True)
class WorkerPoolConfig:
    min_workers: int = 1
    max_workers: int = 8
    scale_up_threshold: float = 0.75  # backlog ratio
    scale_down_threshold: float = 0.25


@dataclass(frozen=True)
class RetryPolicyConfig:
    max_attempts: int = 3
    backoff_base_s: float = 0.01
    backoff_jitter_s: float = 0.01


@dataclass(frozen=True)
class CircuitBreakerConfig:
    failure_threshold: int = 5
    recovery_timeout_s: float = 1.0
    half_open_successes: int = 2


@dataclass(frozen=True)
class OrderingBufferConfig:
    max_pending: int = 32
    forced_flush_ratio: float = 0.9


# ---------------------------------------------------------------------------
# AdaptiveBoundedQueue
# ---------------------------------------------------------------------------


class AdaptiveBoundedQueue:
    """Bounded blocking queue whose capacity can be retuned live.

    Parity: ``ingestion_control_plane.py:49-133``.
    """

    def __init__(self, capacity: int = 8) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self._capacity = capacity
        self._items: Deque[Any] = deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self.total_put = 0
        self.total_get = 0
        self.put_blocked = 0

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._capacity

    def resize(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        with self._lock:
            self._capacity = capacity
            self._not_full.notify_all()

    def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        with self._not_full:
            if len(self._items) >= self._capacity:
                self.put_blocked += 1
                if not self._not_full.wait_for(
                    lambda: len(self._items) < self._capacity, timeout
                ):
                    return False
            self._items.append(item)
            self.total_put += 1
            self._not_empty.notify()
            return True

    def get(self, timeout: Optional[float] = None) -> Tuple[bool, Any]:
        with self._not_empty:
            if not self._items:
                if not self._not_empty.wait_for(lambda: bool(self._items), timeout):
                    return False, None
            item = self._items.popleft()
            self.total_get += 1
            self._not_full.notify()
            return True, item

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def depth_ratio(self) -> float:
        with self._lock:
            return len(self._items) / max(self._capacity, 1)


# ---------------------------------------------------------------------------
# DeterministicEventLog
# ---------------------------------------------------------------------------


class DeterministicEventLog:
    """Bounded thread-safe event ring with monotonically increasing seq ids.

    Parity: ``ingestion_control_plane.py:207-236``.
    """

    def __init__(self, capacity: int = 512, clock: Callable[[], float] = time.time) -> None:
        self.capacity = capacity
        self._clock = clock
        self._events: Deque[Dict[str, Any]] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.total_emitted = 0

    def emit(self, event_type: str, message: str = "", **metadata) -> Dict[str, Any]:
        with self._lock:
            event = {
                "seq": self._seq,
                "type": event_type,
                "message": message,
                "timestamp_s": self._clock(),
                "metadata": dict(metadata),
            }
            self._seq += 1
            self.total_emitted += 1
            self._events.append(event)
            return event

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)


# ---------------------------------------------------------------------------
# CircuitBreaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """closed → open (on threshold failures) → half-open (after timeout) →
    closed (after N half-open successes). Parity: ``ingestion_control_plane.py:348-395``.
    """

    def __init__(
        self,
        config: Optional[CircuitBreakerConfig] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.config = config or CircuitBreakerConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._half_open_successes = 0
        self._opened_at = 0.0
        self.trip_count = 0

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state

    def _maybe_half_open_locked(self) -> None:
        if (
            self._state == "open"
            and self._clock() - self._opened_at >= self.config.recovery_timeout_s
        ):
            self._state = "half_open"
            self._half_open_successes = 0

    def allow(self) -> bool:
        with self._lock:
            self._maybe_half_open_locked()
            return self._state in ("closed", "half_open")

    def record_success(self) -> None:
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == "half_open":
                self._half_open_successes += 1
                if self._half_open_successes >= self.config.half_open_successes:
                    self._state = "closed"
                    self._failures = 0
            elif self._state == "closed":
                self._failures = 0

    def record_failure(self) -> None:
        with self._lock:
            self._maybe_half_open_locked()
            if self._state == "half_open":
                self._state = "open"
                self._opened_at = self._clock()
                self.trip_count += 1
                return
            self._failures += 1
            if self._state == "closed" and self._failures >= self.config.failure_threshold:
                self._state = "open"
                self._opened_at = self._clock()
                self.trip_count += 1


# ---------------------------------------------------------------------------
# DeterministicReorderBuffer
# ---------------------------------------------------------------------------


class DeterministicReorderBuffer:
    """Heap-based sequencer restoring submission order after parallel work.

    ``push(seq, item)`` then ``pop_ready()`` yields items in contiguous seq
    order; when the heap exceeds ``forced_flush_ratio·max_pending`` the
    lowest-seq item is force-flushed (gap skipped, counted). Parity:
    ``ingestion_control_plane.py:398-445``.
    """

    def __init__(self, config: Optional[OrderingBufferConfig] = None, first_seq: int = 0) -> None:
        self.config = config or OrderingBufferConfig()
        self._heap: List[Tuple[int, Any]] = []
        self._next_seq = first_seq
        self._lock = threading.Lock()
        self.forced_flushes = 0
        self.skipped_seqs = 0

    def push(self, seq: int, item: Any) -> None:
        with self._lock:
            heapq.heappush(self._heap, (seq, item))

    def pop_ready(self) -> List[Tuple[int, Any]]:
        out: List[Tuple[int, Any]] = []
        with self._lock:
            while self._heap and self._heap[0][0] == self._next_seq:
                out.append(heapq.heappop(self._heap))
                self._next_seq += 1
            # Forced flush under pressure: jump the gap.
            threshold = max(1, int(self.config.max_pending * self.config.forced_flush_ratio))
            while len(self._heap) >= threshold:
                seq, item = heapq.heappop(self._heap)
                self.forced_flushes += 1
                self.skipped_seqs += max(0, seq - self._next_seq)
                self._next_seq = seq + 1
                out.append((seq, item))
                while self._heap and self._heap[0][0] == self._next_seq:
                    out.append(heapq.heappop(self._heap))
                    self._next_seq += 1
        return out

    def flush_all(self) -> List[Tuple[int, Any]]:
        with self._lock:
            out = sorted(self._heap)
            self._heap.clear()
            if out:
                self._next_seq = out[-1][0] + 1
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)


# ---------------------------------------------------------------------------
# MovingAverage / DynamicWorkerPool / StageSupervisor
# ---------------------------------------------------------------------------


class MovingAverage:
    """EMA. Parity: ``ingestion_control_plane.py:492-510``."""

    def __init__(self, alpha: float = 0.3) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        self.alpha = alpha
        self._value: Optional[float] = None

    def update(self, value: float) -> float:
        self._value = (
            float(value)
            if self._value is None
            else self.alpha * float(value) + (1.0 - self.alpha) * self._value
        )
        return self._value

    @property
    def value(self) -> float:
        return 0.0 if self._value is None else self._value


class DynamicWorkerPool:
    """Target-size bookkeeping for an elastic worker set.

    Parity: ``ingestion_control_plane.py:448-489``. The pipeline owns the
    actual threads; this tracks desired vs active counts deterministically.
    """

    def __init__(self, config: Optional[WorkerPoolConfig] = None) -> None:
        self.config = config or WorkerPoolConfig()
        self._target = self.config.min_workers
        self._lock = threading.Lock()
        self.scale_ups = 0
        self.scale_downs = 0

    @property
    def target(self) -> int:
        with self._lock:
            return self._target

    def scale_up(self) -> int:
        with self._lock:
            if self._target < self.config.max_workers:
                self._target += 1
                self.scale_ups += 1
            return self._target

    def scale_down(self) -> int:
        with self._lock:
            if self._target > self.config.min_workers:
                self._target -= 1
                self.scale_downs += 1
            return self._target


@dataclass
class IngestionFailureReport:
    """Parity: ``ingestion_control_plane.py:250-262``."""

    decoded: int = 0
    failed: int = 0
    dropped: int = 0
    retries: int = 0
    breaker_trips: int = 0
    forced_flushes: int = 0
    failures_by_reason: Dict[str, int] = field(default_factory=dict)

    def record_failure(self, reason: str) -> None:
        self.failed += 1
        self.failures_by_reason[reason] = self.failures_by_reason.get(reason, 0) + 1

    def to_dict(self) -> Dict[str, Any]:
        return {
            "decoded": self.decoded,
            "failed": self.failed,
            "dropped": self.dropped,
            "retries": self.retries,
            "breaker_trips": self.breaker_trips,
            "forced_flushes": self.forced_flushes,
            "failures_by_reason": dict(self.failures_by_reason),
        }


class StageSupervisor:
    """EMA-driven queue resizing + worker scaling decisions per tick.

    Parity: ``ingestion_control_plane.py:513-627``.
    """

    def __init__(
        self,
        queue: AdaptiveBoundedQueue,
        pool: DynamicWorkerPool,
        queue_tuning: Optional[QueueTuningConfig] = None,
        event_log: Optional[DeterministicEventLog] = None,
    ) -> None:
        self.queue = queue
        self.pool = pool
        self.tuning = queue_tuning or QueueTuningConfig()
        self.event_log = event_log or DeterministicEventLog()
        self._depth_ema = MovingAverage()
        self.ticks = 0

    def tick(self) -> Dict[str, Any]:
        self.ticks += 1
        depth = self._depth_ema.update(self.queue.depth_ratio())
        actions: List[str] = []
        if depth > self.tuning.grow_threshold:
            new_cap = min(
                int(self.queue.capacity * self.tuning.grow_factor), self.tuning.max_capacity
            )
            if new_cap > self.queue.capacity:
                self.queue.resize(new_cap)
                actions.append(f"queue_grow:{new_cap}")
            if depth > self.pool.config.scale_up_threshold:
                before = self.pool.target
                if self.pool.scale_up() != before:
                    actions.append(f"workers_up:{self.pool.target}")
        elif depth < self.tuning.shrink_threshold:
            new_cap = max(self.queue.capacity // 2, self.tuning.min_capacity)
            if new_cap < self.queue.capacity:
                self.queue.resize(new_cap)
                actions.append(f"queue_shrink:{new_cap}")
            if depth < self.pool.config.scale_down_threshold:
                before = self.pool.target
                if self.pool.scale_down() != before:
                    actions.append(f"workers_down:{self.pool.target}")
        if actions:
            self.event_log.emit("stage_tuning", message=",".join(actions), depth_ema=depth)
        return {"depth_ema": depth, "actions": actions, "capacity": self.queue.capacity, "workers": self.pool.target}


class ControlPlaneOrchestrator:
    """Periodic supervision loop over stage supervisors.

    Parity: ``ingestion_control_plane.py:630-662``.
    """

    def __init__(self, supervisors: List[StageSupervisor], interval_s: float = 0.05) -> None:
        self.supervisors = list(supervisors)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name="cp-orchestrator", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            for sup in self.supervisors:
                sup.tick()
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
