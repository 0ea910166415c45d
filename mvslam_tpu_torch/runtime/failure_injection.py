"""Deterministic chaos: seeded failure plans, replay harness, chaos runner.

Port of ``mvslam_tpu/runtime/failure_injection.py``: the same numpy RNG
draws, so a plan built from the same config lists the same failures and
has the same digest. Parity: reference ``failure_injection.py`` — seeded schedules of
timeout / dropped_frame / solver_stall failures per stage/step with
probabilities (ref L101-165) and a plan digest (ref L124-127);
``FailureInjectionHarness`` replaying a plan as stage adapters
(snapshots + events) steppable in time (ref L237-317); and a
``FailureInjectionChaosHarness`` driving it from N threads and digesting
the resulting events (ref L320-364).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np

from mvslam_tpu_torch.core.integrity import stable_event_digest, stable_hash
from mvslam_tpu_torch.runtime.hub import ControlPlaneStageAdapter

FAILURE_TYPES = ("timeout", "dropped_frame", "solver_stall")


@dataclass(frozen=True)
class FailureInjectionConfig:
    """Parity: ``failure_injection.py:22-50``."""

    seed: int = 0
    num_steps: int = 100
    stages: Tuple[str, ...] = ("ingestion", "feature", "tracking", "optimization")
    failure_probability: float = 0.05
    type_weights: Mapping[str, float] = field(
        default_factory=lambda: {"timeout": 0.4, "dropped_frame": 0.4, "solver_stall": 0.2}
    )


@dataclass(frozen=True)
class InjectedFailure:
    step: int
    stage: str
    failure_type: str


@dataclass
class FailureInjectionPlan:
    """Parity: ``failure_injection.py:68-88``."""

    config: FailureInjectionConfig
    failures: List[InjectedFailure]

    def digest(self) -> str:
        return stable_hash(
            {
                "seed": self.config.seed,
                "num_steps": self.config.num_steps,
                "failures": [
                    {"step": f.step, "stage": f.stage, "type": f.failure_type}
                    for f in self.failures
                ],
            }
        )

    def failures_at(self, step: int) -> List[InjectedFailure]:
        return [f for f in self.failures if f.step == step]


def build_failure_plan(config: FailureInjectionConfig) -> FailureInjectionPlan:
    """Deterministic seeded schedule. Parity: ``failure_injection.py:101-165``."""
    rng = np.random.default_rng(config.seed)
    types = list(config.type_weights)
    weights = np.asarray([config.type_weights[t] for t in types], dtype=np.float64)
    weights = weights / weights.sum()
    failures: List[InjectedFailure] = []
    for step in range(config.num_steps):
        for stage in config.stages:
            if rng.random() < config.failure_probability:
                ftype = types[int(rng.choice(len(types), p=weights))]
                failures.append(InjectedFailure(step=step, stage=stage, failure_type=ftype))
    return FailureInjectionPlan(config=config, failures=failures)


class FailureInjectionHarness:
    """Replay a plan as live stage adapters (fake multi-stage backend).

    Parity: ``failure_injection.py:237-317``. ``step()`` advances time;
    stage adapters expose health snapshots + accumulated events suitable
    for the hub/supervisor.
    """

    def __init__(self, plan: FailureInjectionPlan, clock=None) -> None:
        self.plan = plan
        self._step = 0
        self._lock = threading.Lock()
        self._events: Dict[str, List[Dict[str, Any]]] = {s: [] for s in plan.config.stages}
        self._failure_counts: Dict[str, int] = {s: 0 for s in plan.config.stages}
        self._clock = clock or (lambda: float(self._step))

    @property
    def current_step(self) -> int:
        with self._lock:
            return self._step

    def step(self) -> List[InjectedFailure]:
        with self._lock:
            fired = self.plan.failures_at(self._step)
            for failure in fired:
                self._failure_counts[failure.stage] += 1
                self._events[failure.stage].append(
                    {
                        "type": f"injected_{failure.failure_type}",
                        "message": f"{failure.failure_type}@step{failure.step}",
                        "timestamp_s": float(failure.step),
                        "metadata": {"step": failure.step, "stage": failure.stage},
                    }
                )
            self._step += 1
            return fired

    def run_all(self) -> int:
        count = 0
        while self.current_step < self.plan.config.num_steps:
            count += len(self.step())
        return count

    def stage_events(self, stage: str) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events[stage])

    def stage_snapshot(self, stage: str) -> Dict[str, Any]:
        with self._lock:
            failures = self._failure_counts[stage]
            state = "healthy" if failures == 0 else ("degraded" if failures < 5 else "tripped")
            return {"stage": stage, "state": state, "injected_failures": failures}

    def adapters(self) -> List[ControlPlaneStageAdapter]:
        return [
            ControlPlaneStageAdapter(
                name=stage,
                health_snapshot=lambda s=stage: self.stage_snapshot(s),
                events=lambda s=stage: self.stage_events(s),
            )
            for stage in self.plan.config.stages
        ]


class FailureInjectionChaosHarness:
    """Drive a harness from N threads; assert deterministic digests after.

    Parity: ``failure_injection.py:320-364``.
    """

    def __init__(self, plan: FailureInjectionPlan, num_threads: int = 4) -> None:
        self.plan = plan
        self.num_threads = num_threads

    def run(self) -> Dict[str, Any]:
        harness = FailureInjectionHarness(self.plan)
        total = self.plan.config.num_steps

        def worker():
            while True:
                with harness._lock:
                    done = harness._step >= total
                if done:
                    return
                harness.step()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        all_events: List[Dict[str, Any]] = []
        for stage in sorted(self.plan.config.stages):
            all_events.extend(harness.stage_events(stage))
        all_events.sort(key=lambda e: (e["timestamp_s"], e["type"], e["message"]))
        return {
            "fired": len(all_events),
            "event_digest": stable_event_digest(all_events),
            "plan_digest": self.plan.digest(),
        }
