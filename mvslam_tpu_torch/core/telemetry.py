"""Run telemetry: timed events, correlation IDs, JSON persistence.

Counterpart of the reference's ``run_telemetry.py:22-184``. Every pipeline
stage is wrapped in :func:`timed_event`, which records wall duration,
optional ``tracemalloc`` memory deltas, and success/error state into a
thread-safe recorder. Correlation IDs are *derived* (stable hash of seed /
config hash / run id / stage) rather than random, so two identical runs
emit identical correlation IDs — the property the determinism validator
asserts.

Port of ``mvslam_tpu/core/telemetry.py``. :func:`timed_device_event`
synchronises the CUDA streams of the stage's returned tensors before
stopping the clock, so device time is attributed to the stage that launched
it instead of to whichever stage first forces the value.
"""

from __future__ import annotations

import threading
import time
import tracemalloc
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional

import json

from mvslam_tpu_torch.core.integrity import stable_hash


@dataclass(frozen=True)
class TelemetryEvent:
    """One recorded stage execution. Parity: ``run_telemetry.py:22-29``."""

    name: str
    duration_s: float
    timestamp_s: float
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "duration_s": self.duration_s,
            "timestamp_s": self.timestamp_s,
            "metadata": dict(self.metadata),
        }


class TelemetryCorrelationRegistry:
    """Deterministic stage → correlation-id mapping.

    Parity: ``run_telemetry.py:32-72``. IDs are the first 16 hex chars of
    ``stable_hash({seed, config_hash, run_id, stage})``.
    """

    def __init__(self, seed: int, config_hash: str, run_id: str) -> None:
        self._seed = seed
        self._config_hash = config_hash
        self._run_id = run_id
        self._cache: Dict[str, str] = {}
        self._lock = threading.Lock()

    def correlation_id(self, stage: str) -> str:
        with self._lock:
            cached = self._cache.get(stage)
            if cached is None:
                cached = stable_hash(
                    {
                        "seed": self._seed,
                        "config_hash": self._config_hash,
                        "run_id": self._run_id,
                        "stage": stage,
                    }
                )[:16]
                self._cache[stage] = cached
            return cached

    def snapshot(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._cache)


class RunTelemetryRecorder:
    """Thread-safe in-memory event list, flushable to a JSON array file.

    Parity: ``run_telemetry.py:82-137``.
    """

    def __init__(self, run_id: str = "run", clock=time.time) -> None:
        self.run_id = run_id
        self._clock = clock
        self._events: List[TelemetryEvent] = []
        self._lock = threading.Lock()

    def record(
        self,
        name: str,
        duration_s: float,
        metadata: Optional[Mapping[str, Any]] = None,
        timestamp_s: Optional[float] = None,
    ) -> TelemetryEvent:
        event = TelemetryEvent(
            name=name,
            duration_s=float(duration_s),
            timestamp_s=self._clock() if timestamp_s is None else float(timestamp_s),
            metadata=dict(metadata or {}),
        )
        with self._lock:
            self._events.append(event)
        return event

    def events(self) -> List[TelemetryEvent]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def flush_to_json(self, path: Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with self._lock:
            payload = [e.to_dict() for e in self._events]
        path.write_text(json.dumps(payload, indent=2))
        return path


@contextmanager
def timed_event(
    recorder: Optional[RunTelemetryRecorder],
    name: str,
    metadata: Optional[Mapping[str, Any]] = None,
    track_memory: bool = False,
) -> Iterator[Dict[str, Any]]:
    """Context manager recording duration + memory delta + success/error.

    Parity: ``run_telemetry.py:140-184``. Yields a mutable metadata dict so
    the wrapped stage can attach result fields (match counts, inlier
    ratios, ...) to the emitted event.
    """
    meta: Dict[str, Any] = dict(metadata or {})
    mem_started_here = False
    if track_memory:
        if not tracemalloc.is_tracing():
            tracemalloc.start()
            mem_started_here = True
        snap_before = tracemalloc.get_traced_memory()[0]
    start = time.perf_counter()
    try:
        yield meta
        meta.setdefault("success", True)
    except BaseException as exc:
        meta["success"] = False
        meta["error"] = f"{type(exc).__name__}: {exc}"
        raise
    finally:
        duration = time.perf_counter() - start
        if track_memory:
            meta["memory_delta_bytes"] = tracemalloc.get_traced_memory()[0] - snap_before
            if mem_started_here:
                tracemalloc.stop()
        if recorder is not None:
            recorder.record(name, duration, metadata=meta)


def _synchronize(tree) -> None:
    """Wait for the CUDA devices holding any tensor in ``tree``."""
    import torch

    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                visit(v)

    visit(tree)
    for device in devices:
        torch.cuda.synchronize(device)


@contextmanager
def timed_device_event(
    recorder: Optional[RunTelemetryRecorder],
    name: str,
    metadata: Optional[Mapping[str, Any]] = None,
) -> Iterator[Dict[str, Any]]:
    """Like :func:`timed_event` but the stage stores its device outputs in
    ``meta['__sync__']`` (a tensor or a nested tuple/list/dict of tensors);
    the devices of its CUDA tensors are synchronised before the clock stops
    so async dispatch time is attributed correctly.
    """
    meta: Dict[str, Any] = dict(metadata or {})
    start = time.perf_counter()
    try:
        yield meta
        sync_target = meta.pop("__sync__", None)
        if sync_target is not None:
            _synchronize(sync_target)
        meta.setdefault("success", True)
    except BaseException as exc:
        meta.pop("__sync__", None)
        meta["success"] = False
        meta["error"] = f"{type(exc).__name__}: {exc}"
        raise
    finally:
        duration = time.perf_counter() - start
        if recorder is not None:
            recorder.record(name, duration, metadata=meta)
