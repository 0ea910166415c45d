"""Run telemetry: spans on one clock, their links, device spans, JSON persistence.

Counterpart of the reference's ``run_telemetry.py:22-184``. Every pipeline
stage is wrapped in :func:`timed_event`, which records the span's start,
end and success/error state into a thread-safe recorder. Correlation IDs
are *derived* (stable hash of seed / config hash / run id / stage) rather
than random, so two identical runs emit identical correlation IDs — the
property the determinism validator asserts.

One clock: a recorder stamps every span from ``time.perf_counter_ns``,
mapped to unix time by an anchor it takes once (``time.time_ns`` and
``perf_counter_ns`` read together), so spans on every thread, and the
device profiler's records (unix nanoseconds), share one time line. Each
span has an id, the id of the span that encloses it on its thread
(``parent_id``) and its thread's name; a span of one frame carries the
frame's id as ``metadata["frame_id"]``, the link between its spans on
different threads.

:func:`device_span` brackets a stage's launches with two CUDA events on
the current stream, at no synchronisation: the events are placed on the
recorder's clock later (see :class:`_DeviceClock`) and recorded as an
event named ``<stage>.device``, from the stage's first device work to its
last.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional

import json

from mvslam_tpu_torch.core.integrity import stable_hash


@dataclass(frozen=True)
class TelemetryEvent:
    """One recorded span. Parity: ``run_telemetry.py:22-29``; ``timestamp_s``
    is the span's end and ``duration_s`` its end less ``start_s``."""

    name: str
    duration_s: float
    timestamp_s: float
    metadata: Dict[str, Any] = field(default_factory=dict)
    start_s: float = 0.0
    span_id: int = 0
    parent_id: Optional[int] = None
    thread: str = ""

    def to_dict(self) -> Dict[str, Any]:
        # ``start_s`` is left out: it is ``timestamp_s - duration_s``, and the
        # determinism digests skip those two as volatile.
        return {
            "name": self.name,
            "duration_s": self.duration_s,
            "timestamp_s": self.timestamp_s,
            "metadata": dict(self.metadata),
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "thread": self.thread,
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


# A device clock's anchor is renewed at the first idle moment of its stream
# after this many seconds, which bounds the drift between the device's
# event timer and the host's clock that a span can carry.
_REANCHOR_S = 0.1
# An anchor is taken again, up to a few times, when the host times that
# bracket its event's stamp lie further apart than this (the thread was
# descheduled in between); the longest wait for one attempt's event.
_ANCHOR_SLACK_S = 30e-6
_ANCHOR_TRIES = 3
_ANCHOR_WAIT_S = 200e-6


class _DeviceClock:
    """Places one CUDA device's events on the recorder's clock.

    An anchor is an event recorded while its stream was idle, so the device
    stamps it at once, and the recorder's time at that stamp: the middle of
    the last time read before the event was seen incomplete (or recorded)
    and the first time read after it was seen complete. Any later event's
    time is its anchor's plus the device's elapsed time between the two.
    """

    def __init__(self, now) -> None:
        self._now = now
        self.anchor = None  # (event, recorder seconds)

    def _attempt(self, stream):
        """One anchor event and the host times ``(lo, hi)`` around its stamp."""
        import torch

        event = torch.cuda.Event(enable_timing=True)
        start = lo = self._now()
        event.record(stream)
        while True:
            before = self._now()
            if event.query():
                return event, lo, self._now()
            if before - start > _ANCHOR_WAIT_S:
                event.synchronize()
                return event, lo, self._now()
            lo = before

    def _take_anchor(self, stream) -> None:
        best = None
        for _ in range(_ANCHOR_TRIES):
            event, lo, hi = self._attempt(stream)
            if best is None or hi - lo < best[2] - best[1]:
                best = (event, lo, hi)
            if hi - lo <= _ANCHOR_SLACK_S:
                break
        event, lo, hi = best
        self.anchor = (event, 0.5 * (lo + hi))

    def mark(self, stream):
        """Record an event on ``stream``; first renew the anchor when it is
        old and the stream idle. Returns ``(event, anchor)``."""
        import torch

        if self.anchor is None:
            stream.synchronize()  # once per device and recorder, in the first span
            self._take_anchor(stream)
        elif self._now() - self.anchor[1] > _REANCHOR_S and stream.query():
            self._take_anchor(stream)
        event = torch.cuda.Event(enable_timing=True)
        event.record(stream)
        return event, self.anchor


@dataclass
class _PendingDeviceSpan:
    name: str
    span_id: int
    parent_id: Optional[int]
    metadata: Dict[str, Any]
    start: Any  # torch.cuda.Event
    end: Any
    anchor: tuple  # (torch.cuda.Event, recorder seconds)

    def done(self) -> bool:
        return self.end.query() and self.anchor[0].query()

    def resolve(self) -> TelemetryEvent:
        anchor, at = self.anchor
        start = at + anchor.elapsed_time(self.start) / 1e3
        end = at + anchor.elapsed_time(self.end) / 1e3
        return TelemetryEvent(self.name, end - start, end, self.metadata, start, self.span_id, self.parent_id, "device")


class RunTelemetryRecorder:
    """Thread-safe in-memory event list, flushable to a JSON array file.

    Parity: ``run_telemetry.py:82-137``. ``clock`` (seconds) replaces the
    recorder's own clock for every stamp; by default spans are stamped on
    ``perf_counter_ns`` mapped to unix time at construction.
    """

    def __init__(self, run_id: str = "run", clock=None) -> None:
        self.run_id = run_id
        self._clock = clock
        self._unix0_ns = time.time_ns()
        self._perf0_ns = time.perf_counter_ns()
        self._events: List[TelemetryEvent] = []
        self._pending: List[_PendingDeviceSpan] = []
        self._device_clocks: Dict[Any, _DeviceClock] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._local = threading.local()

    def now(self) -> float:
        """Seconds since the epoch on the recorder's clock."""
        if self._clock is not None:
            return self._clock()
        return (self._unix0_ns + time.perf_counter_ns() - self._perf0_ns) / 1e9

    def _stack(self) -> List[int]:
        """The ids of the spans open on the calling thread, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, event: TelemetryEvent) -> TelemetryEvent:
        with self._lock:
            self._events.append(event)
        return event

    def record(
        self,
        name: str,
        duration_s: float,
        metadata: Optional[Mapping[str, Any]] = None,
        timestamp_s: Optional[float] = None,
    ) -> TelemetryEvent:
        """An event of ``duration_s`` ending at ``timestamp_s`` (now by default)."""
        end = self.now() if timestamp_s is None else float(timestamp_s)
        return self.span(name, end - float(duration_s), end, metadata)

    def span(
        self, name: str, start_s: float, end_s: float, metadata: Optional[Mapping[str, Any]] = None
    ) -> TelemetryEvent:
        """A span stamped by its caller on this recorder's clock, a child of
        the span open on the calling thread."""
        stack = self._stack()
        return self._append(
            TelemetryEvent(
                name, end_s - start_s, end_s, dict(metadata or {}), start_s,
                next(self._ids), stack[-1] if stack else None, threading.current_thread().name,
            )
        )

    def _device_mark(self, device, stream):
        with self._lock:
            clock = self._device_clocks.get(device)
            if clock is None:
                clock = self._device_clocks[device] = _DeviceClock(self.now)
            return clock.mark(stream)

    def _add_pending(self, span: _PendingDeviceSpan) -> None:
        with self._lock:
            self._pending.append(span)

    def _place_device_spans(self, wait: bool = False) -> None:
        """Turn the device spans whose events have completed into events;
        with ``wait``, wait for them all. Without, stop at the first one
        still running (a stream completes its events in order)."""
        with self._lock:
            pending = self._pending
            done = 0
            for span in pending:
                if wait:
                    span.end.synchronize()
                    span.anchor[0].synchronize()
                elif not span.done():
                    break
                self._events.append(span.resolve())
                done += 1
            del pending[:done]

    def events(self) -> List[TelemetryEvent]:
        self._place_device_spans(wait=True)
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def flush_to_json(self, path: Path) -> Path:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        payload = [e.to_dict() for e in self.events()]
        path.write_text(json.dumps(payload, indent=2))
        return path


@contextmanager
def timed_event(
    recorder: Optional[RunTelemetryRecorder],
    name: str,
    metadata: Optional[Mapping[str, Any]] = None,
) -> Iterator[Dict[str, Any]]:
    """Context manager recording a span: start, end, success/error, its
    parent (the span open around it on this thread) and its thread.

    Parity: ``run_telemetry.py:140-184``. Yields a mutable metadata dict so
    the wrapped stage can attach result fields (match counts, inlier
    ratios, ...) to the emitted event.
    """
    meta: Dict[str, Any] = dict(metadata or {})
    if recorder is None:
        yield meta
        return
    span_id = next(recorder._ids)
    stack = recorder._stack()
    parent = stack[-1] if stack else None
    stack.append(span_id)
    start = recorder.now()
    try:
        yield meta
        meta.setdefault("success", True)
    except BaseException as exc:
        meta["success"] = False
        meta["error"] = f"{type(exc).__name__}: {exc}"
        raise
    finally:
        end = recorder.now()
        stack.pop()
        recorder._append(
            TelemetryEvent(name, end - start, end, meta, start, span_id, parent, threading.current_thread().name)
        )


# Device spans are placed on the clock when read (``events``), or on the
# hot path only when this many wait.
_PENDING_CAP = 4096


class _DeviceSpan:
    """Two CUDA events around a stage's launches on the current stream."""

    def __init__(self, recorder: RunTelemetryRecorder, stage: str, device, metadata) -> None:
        self._recorder = recorder
        self._name = f"{stage}.device"
        self._device = device
        self._metadata = dict(metadata or {})

    def __enter__(self):
        import torch

        recorder = self._recorder
        if len(recorder._pending) >= _PENDING_CAP:
            recorder._place_device_spans()
        self._stream = torch.cuda.current_stream(self._device)
        stack = recorder._stack()
        self._parent = stack[-1] if stack else None
        self._id = next(recorder._ids)
        self._start, self._anchor = recorder._device_mark(self._device, self._stream)
        return self

    def __exit__(self, *exc) -> None:
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record(self._stream)
        self._recorder._add_pending(
            _PendingDeviceSpan(self._name, self._id, self._parent, self._metadata, self._start, end, self._anchor)
        )


def device_span(recorder: Optional[RunTelemetryRecorder], stage: str, device, metadata=None):
    """Context manager recording the device time of the launches inside it
    as ``<stage>.device``: from the stage's first device work to its last,
    which includes any wait for the host's launches in between. Costs two
    CUDA event records and no synchronisation; the span's parent is the
    host span open around it. Records nothing without a recorder or off a
    CUDA device."""
    if recorder is None or device.type != "cuda":
        return nullcontext()
    return _DeviceSpan(recorder, stage, device, metadata)
