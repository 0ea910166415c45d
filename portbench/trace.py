"""Device trace of a stretch of the window, and what the readers take from it.

``torch.profiler`` with CUDA activity only (its CPU-side records would
slow the host path it measures): every kernel, copy and fill on the card
with its start and end. From those: the device's busy time (the union of
the intervals), the kernels by name, and the idle gaps, each named by the
innermost of the program's telemetry spans that covers it on the host.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Trace:
    window_s: float = 0.0
    started_unix: float = 0.0
    stopped_unix: float = 0.0
    ops: List[Tuple[str, float, float]] = field(default_factory=list)  # (name, start s, end s), unix
    kernels: int = 0
    frames: int = 0  # frames the program tracked inside the traced stretch
    launch_shapes: Dict[str, collections.Counter] = field(default_factory=dict)

    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.ops])

    def device_seconds(self, name_part: Optional[str] = None) -> float:
        return sum(e - s for n, s, e in self.ops if name_part is None or name_part in n)

    def count(self, name_part: str) -> int:
        return sum(1 for n, _, _ in self.ops if name_part in n)


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def idle_gaps(intervals, start: float, stop: float) -> List[Tuple[float, float]]:
    """The stretches of [start, stop] that no interval covers."""
    gaps, cursor = [], start
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, stop)))
        cursor = max(cursor, e)
        if cursor >= stop:
            break
    if cursor < stop:
        gaps.append((cursor, stop))
    return [(a, b) for a, b in gaps if b > a]


_COPY_KINDS = ("Memcpy", "Memset", "memcpy", "memset")


class DeviceTracer:
    """Starts and stops ``torch.profiler`` around a stretch of the window and
    keeps the device's records, with the kernel wrappers' launch counts by
    shape over the same stretch."""

    def __init__(self, counters: Dict[str, object]):
        self.counters = counters  # name -> wrapper with ``launch_shapes``
        self._prof = None
        self._before = {}
        self.trace: Optional[Trace] = None
        self.overhead = {}  # seconds the profiler took to start, stop and be read

    @property
    def active(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if not torch.cuda.is_available() or ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError("the device trace needs the profiler's CUDA activity")
        torch.cuda.synchronize()
        self._before = {k: collections.Counter(w.launch_shapes) for k, w in self.counters.items()}
        started = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()
        self.overhead["start"] = self._t0 - started
        self._unix0 = time.time()

    def stop(self, frames: int) -> Trace:
        import torch

        torch.cuda.synchronize()
        window = time.perf_counter() - self._t0
        unix1 = time.time()
        stopping = time.perf_counter()
        self._prof.stop()
        reading = time.perf_counter()
        self.overhead["stop"] = reading - stopping
        shapes = {
            k: collections.Counter(w.launch_shapes) - self._before[k] for k, w in self.counters.items()
        }
        ops = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            start, end = ev.start_ns() / 1e9, ev.end_ns() / 1e9
            if end > start:
                ops.append((ev.name(), start, end))
        self._prof = None
        if not ops:
            raise RuntimeError("the profiler recorded no CUDA activity in the traced stretch")
        self.overhead["read"] = time.perf_counter() - reading
        kernels = sum(1 for n, _, _ in ops if not any(k in n for k in _COPY_KINDS))
        self.trace = Trace(window, self._unix0, unix1, ops, kernels, frames, shapes)
        return self.trace


def breakdown(trace: Trace, spans: List[Tuple[str, float, float]], top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle gaps
    named by the innermost telemetry span around each (``outside_spans``
    where none is)."""
    by_name = collections.Counter()
    for n, s, e in trace.ops:
        by_name[n] += e - s
    if trace.ops:
        lo = min(s for _, s, _ in trace.ops)
        hi = max(e for _, _, e in trace.ops)
        start, stop = min(lo, trace.started_unix), max(hi, trace.stopped_unix)
    else:
        start, stop = trace.started_unix, trace.stopped_unix
    gaps = idle_gaps([(s, e) for _, s, e in trace.ops], start, stop)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        around = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        named.append([min(around)[1] if around else "outside_spans", b - a])
    return {
        "device_ops": [[n, v] for n, v in by_name.most_common(top)],
        "idle_gaps": named,
    }
