"""Cross-stage health FSM with dependency propagation and recovery.

Port of ``mvslam_tpu/runtime/supervisor.py`` (pure host code). Parity:
reference ``control_plane_supervisor.py`` — per-stage FSM
healthy → degraded → tripped → recovering (error-keyword event counting in
a window, ref L271-276; backpressure/breaker escalation, ref L318-410),
state propagation along the stage dependency DAG ingestion → feature →
tracking → optimization (ref L17-21, L296-316), recovery cooldown + N
consecutive healthy observations (ref L412-484), a bounded deterministic
``RecoveryQueue`` sorted by (severity, time, stage, seq) (ref L199-227,
L559-561), and a global state + stable digest (ref L486-517).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from mvslam_tpu_torch.core.integrity import stable_hash

# Stage dependency DAG (parity: control_plane_supervisor.py:17-21).
STAGE_DEPENDENCIES: Dict[str, Tuple[str, ...]] = {
    "ingestion": (),
    "feature": ("ingestion",),
    "tracking": ("feature",),
    "optimization": ("tracking",),
}

_STATE_SEVERITY = {"healthy": 0, "recovering": 1, "degraded": 2, "tripped": 3}
_ERROR_KEYWORDS = ("error", "failed", "failure", "timeout", "dropped", "breaker")


@dataclass(frozen=True)
class ControlPlaneSupervisorConfig:
    """Parity: ``control_plane_supervisor.py:51-105``."""

    error_window: int = 20
    degraded_error_count: int = 3
    tripped_error_count: int = 8
    backpressure_degraded_ratio: float = 0.8
    breaker_trips_degraded: int = 1
    breaker_trips_tripped: int = 3
    recovery_cooldown_s: float = 0.5
    consecutive_healthy_required: int = 2
    recovery_queue_capacity: int = 32
    propagate_dependencies: bool = True


@dataclass(frozen=True)
class RecoveryTask:
    severity: int
    enqueued_at: float
    stage: str
    seq: int
    reason: str

    def sort_key(self):
        return (-self.severity, self.enqueued_at, self.stage, self.seq)


class RecoveryQueue:
    """Bounded deterministic priority queue of recovery tasks.

    Parity: ``control_plane_supervisor.py:199-227``.
    """

    def __init__(self, capacity: int = 32) -> None:
        self.capacity = capacity
        self._tasks: List[RecoveryTask] = []
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped = 0

    def enqueue(self, stage: str, severity: int, reason: str, now: float) -> None:
        with self._lock:
            task = RecoveryTask(severity, now, stage, self._seq, reason)
            self._seq += 1
            self._tasks.append(task)
            self._tasks.sort(key=RecoveryTask.sort_key)
            while len(self._tasks) > self.capacity:
                self._tasks.pop()  # drop lowest priority
                self.dropped += 1

    def drain(self) -> List[RecoveryTask]:
        with self._lock:
            out = list(self._tasks)
            self._tasks.clear()
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._tasks)


@dataclass
class StageState:
    state: str = "healthy"
    consecutive_healthy: int = 0
    last_transition_s: float = 0.0
    last_breaker_trips: int = 0


class ControlPlaneSupervisor:
    """Observe stage snapshots/events each update; run the FSM + DAG.

    Parity: ``control_plane_supervisor.py:230-541``.
    """

    def __init__(
        self,
        config: Optional[ControlPlaneSupervisorConfig] = None,
        dependencies: Optional[Mapping[str, Tuple[str, ...]]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.config = config or ControlPlaneSupervisorConfig()
        self.dependencies = dict(dependencies or STAGE_DEPENDENCIES)
        self.clock = clock
        self.states: Dict[str, StageState] = {}
        self.recovery_queue = RecoveryQueue(self.config.recovery_queue_capacity)
        self.transitions: List[Dict[str, Any]] = []

    def _observe_stage(
        self,
        stage: str,
        snapshot: Mapping[str, Any],
        events: List[Mapping[str, Any]],
        now: float,
    ) -> str:
        """Raw (pre-propagation) state from a stage's own signals."""
        window = events[-self.config.error_window :]
        error_count = 0
        for event in window:
            text = f"{event.get('type', '')} {event.get('message', '')}".lower()
            if any(k in text for k in _ERROR_KEYWORDS):
                error_count += 1
        backpressure = float(
            snapshot.get("backpressure_ratio", snapshot.get("entry_queue_depth", 0) and 0.0)
        )
        if "entry_queue_depth" in snapshot and "entry_capacity" in snapshot:
            backpressure = snapshot["entry_queue_depth"] / max(snapshot["entry_capacity"], 1)
        breaker_trips = int(snapshot.get("breaker_trips", 0))
        breaker_open = str(snapshot.get("breaker_state", "")) == "open"

        if (
            error_count >= self.config.tripped_error_count
            or breaker_open
            or breaker_trips >= self.config.breaker_trips_tripped
        ):
            return "tripped"
        if (
            error_count >= self.config.degraded_error_count
            or backpressure >= self.config.backpressure_degraded_ratio
            or breaker_trips >= self.config.breaker_trips_degraded
        ):
            return "degraded"
        return "healthy"

    def update(
        self,
        observations: Mapping[str, Tuple[Mapping[str, Any], List[Mapping[str, Any]]]],
    ) -> Dict[str, str]:
        """observations: stage → (health_snapshot, events). Returns states.

        Parity: ``control_plane_supervisor.py:245-266``.
        """
        now = self.clock()
        raw: Dict[str, str] = {}
        for stage in sorted(observations):
            snapshot, events = observations[stage]
            raw[stage] = self._observe_stage(stage, snapshot, list(events), now)

        # Dependency propagation: a stage is at least as sick as its deps
        # (one level below tripped → degraded). Parity: ref L296-316.
        effective = dict(raw)
        if self.config.propagate_dependencies:
            for stage in sorted(effective):
                for dep in self.dependencies.get(stage, ()):
                    dep_state = effective.get(dep, "healthy")
                    if dep_state == "tripped" and _STATE_SEVERITY[effective[stage]] < 2:
                        effective[stage] = "degraded"
                    elif dep_state == "degraded" and _STATE_SEVERITY[effective[stage]] < 1:
                        effective[stage] = "recovering"

        # FSM with cooldown + consecutive-healthy requirement (ref L412-484).
        out: Dict[str, str] = {}
        for stage in sorted(effective):
            st = self.states.setdefault(stage, StageState(last_transition_s=now))
            observed = effective[stage]
            current = st.state
            new_state = current
            if observed in ("degraded", "tripped"):
                new_state = observed
                st.consecutive_healthy = 0
                if observed == "tripped" and current != "tripped":
                    self.recovery_queue.enqueue(stage, _STATE_SEVERITY[observed], "stage_tripped", now)
            else:  # observed healthy-ish
                if current in ("tripped", "degraded"):
                    if now - st.last_transition_s >= self.config.recovery_cooldown_s:
                        new_state = "recovering"
                        st.consecutive_healthy = 0
                elif current == "recovering":
                    st.consecutive_healthy += 1
                    if st.consecutive_healthy >= self.config.consecutive_healthy_required:
                        new_state = "healthy"
                else:
                    new_state = "healthy"
            if new_state != current:
                st.last_transition_s = now
                self.transitions.append(
                    {"stage": stage, "from": current, "to": new_state, "timestamp_s": now}
                )
            st.state = new_state
            out[stage] = new_state
        return out

    def global_state(self) -> str:
        """Worst stage state. Parity: ``control_plane_supervisor.py:486-517``."""
        if not self.states:
            return "healthy"
        return max((s.state for s in self.states.values()), key=lambda s: _STATE_SEVERITY[s])

    def digest(self) -> str:
        return stable_hash(
            {
                "states": {k: v.state for k, v in sorted(self.states.items())},
                "transitions": [
                    {k: t[k] for k in ("stage", "from", "to")} for t in self.transitions
                ],
            }
        )

    def snapshot(self) -> Dict[str, Any]:
        return {
            "global_state": self.global_state(),
            "stages": {k: v.state for k, v in sorted(self.states.items())},
            "pending_recoveries": len(self.recovery_queue),
            "digest": self.digest(),
        }
