"""Unified control-plane reporting: adapters, event merge, digests.

Port of ``mvslam_tpu/runtime/hub.py``; its digests are the reference's
strings for the same reports (``core.integrity``). Parity: reference ``control_plane_hub.py`` — ``ControlPlaneStageAdapter``
(name + health_snapshot + events callables, ref L73-79),
``generate_report()`` sorting adapters, sorting each stream by
(timestamp, type, message, stable_hash(metadata)) and heap k-way merging
into a single ordered event stream (ref L145-205), digests for the
overall report / event stream / snapshots (ref L133-141, L207-216), and a
bounded thread-safe ``DeterministicEventBus`` (ref L82-109).
"""

from __future__ import annotations

import heapq
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional

from mvslam_tpu_torch.core.integrity import stable_event_digest, stable_hash


@dataclass(frozen=True)
class StageHealthSnapshot:
    """Parity: ``control_plane_hub.py:25-33``."""

    stage: str
    state: str  # healthy | degraded | tripped | recovering
    metrics: Mapping[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {"stage": self.stage, "state": self.state, "metrics": dict(self.metrics)}


@dataclass(frozen=True)
class StageEventEnvelope:
    """Parity: ``control_plane_hub.py:36-48``."""

    stage: str
    event_type: str
    message: str
    timestamp_s: float
    metadata: Mapping[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "stage": self.stage,
            "type": self.event_type,
            "message": self.message,
            "timestamp_s": self.timestamp_s,
            "metadata": dict(self.metadata),
        }

    def sort_key(self):
        return (
            self.timestamp_s,
            self.event_type,
            self.message,
            stable_hash(dict(self.metadata)),
        )


@dataclass
class ControlPlaneStageAdapter:
    """Parity: ``control_plane_hub.py:73-79``."""

    name: str
    health_snapshot: Callable[[], Mapping[str, Any]]
    events: Callable[[], Iterable[Mapping[str, Any]]]

    def envelopes(self) -> List[StageEventEnvelope]:
        out = []
        for event in self.events():
            out.append(
                StageEventEnvelope(
                    stage=self.name,
                    event_type=str(event.get("type", "event")),
                    message=str(event.get("message", "")),
                    timestamp_s=float(event.get("timestamp_s", 0.0)),
                    metadata=dict(event.get("metadata", {})),
                )
            )
        return out


class DeterministicEventBus:
    """Bounded thread-safe pub-sub buffer. Parity: ``control_plane_hub.py:82-109``."""

    def __init__(self, capacity: int = 1024) -> None:
        self._events: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.total_published = 0

    def publish(self, event: Mapping[str, Any]) -> None:
        with self._lock:
            self._events.append(dict(event))
            self.total_published += 1

    def drain(self) -> List[Dict[str, Any]]:
        with self._lock:
            out = list(self._events)
            self._events.clear()
            return out


@dataclass
class ControlPlaneReport:
    """Parity: ``control_plane_hub.py:51-70``."""

    snapshots: Dict[str, Dict[str, Any]]
    events: List[Dict[str, Any]]
    event_digest: str
    snapshot_digest: str
    overall_digest: str

    def to_dict(self) -> Dict[str, Any]:
        return {
            "snapshots": self.snapshots,
            "events": self.events,
            "event_digest": self.event_digest,
            "snapshot_digest": self.snapshot_digest,
            "overall_digest": self.overall_digest,
        }

    # Readiness-report compatibility: stage → {state}.
    @property
    def stages(self) -> Dict[str, Dict[str, Any]]:
        return {
            name: {"state": snap.get("state", "unknown")} for name, snap in self.snapshots.items()
        }


class ControlPlaneHub:
    """Merge every stage's health + events into one deterministic report.

    Parity: ``control_plane_hub.py:112-216``.
    """

    def __init__(self, adapters: Optional[List[ControlPlaneStageAdapter]] = None) -> None:
        self.adapters: List[ControlPlaneStageAdapter] = list(adapters or [])

    def register(self, adapter: ControlPlaneStageAdapter) -> None:
        self.adapters.append(adapter)

    def generate_report(self) -> ControlPlaneReport:
        adapters = sorted(self.adapters, key=lambda a: a.name)
        snapshots = {a.name: dict(a.health_snapshot()) for a in adapters}
        # Per-stage deterministic sort, then heap k-way merge.
        streams = []
        for adapter in adapters:
            stream = sorted(adapter.envelopes(), key=StageEventEnvelope.sort_key)
            if stream:
                streams.append(stream)
        merged: List[Dict[str, Any]] = []
        heap = [
            (stream[0].sort_key(), si, 0, stream[0]) for si, stream in enumerate(streams)
        ]
        heapq.heapify(heap)
        while heap:
            _, si, idx, env = heapq.heappop(heap)
            merged.append(env.to_dict())
            nxt = idx + 1
            if nxt < len(streams[si]):
                heapq.heappush(heap, (streams[si][nxt].sort_key(), si, nxt, streams[si][nxt]))
        event_digest = stable_event_digest(merged)
        snapshot_digest = stable_hash(snapshots, exclude_keys=("timestamp_s", "timestamp"))
        overall_digest = stable_hash(
            {"events": merged, "snapshots": snapshots},
            exclude_keys=("timestamp_s", "timestamp"),
        )
        return ControlPlaneReport(
            snapshots=snapshots,
            events=merged,
            event_digest=event_digest,
            snapshot_digest=snapshot_digest,
            overall_digest=overall_digest,
        )
