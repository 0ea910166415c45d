"""Optimization supervision: conditioning gates, retry escalation, snapshots.

Port of ``mvslam_tpu/backend/optimization_control.py``:
``OptimizationSupervisor.run`` with a pre-solve conditioning gate (a trip
returns x0 unchanged with status −2), a retry loop of at most N attempts
escalating the robust-loss scale ×(1, 1.5, 2, …) and the damping ×2^k, a
``SolverSnapshot`` carrying the problem digest, per-iteration diagnostics
and the residual histogram, a ``SolverRegressionGate`` comparing each run
with the previous one, a deterministic event log and a ``health_snapshot``.
The problem digest hashes the problem's tensors as numpy arrays of the
reference's dtypes (float32 values, int32 edges), so digests and event
digests are the reference's strings.
"""

from __future__ import annotations

import dataclasses
import random
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from mvslam_tpu_torch.backend.factor_graph import GraphProblem
from mvslam_tpu_torch.backend.solvers import (
    DEFAULT_REGISTRY,
    SolverConfig,
    SolverRegistry,
    SolverResult,
    conditioning_stats,
)
from mvslam_tpu_torch.core.integrity import stable_event_digest, stable_hash
from mvslam_tpu_torch.core.persistence import StreamingMoments


@dataclass(frozen=True)
class OptimizationControlConfig:
    max_attempts: int = 3
    loss_scale_escalation: tuple = (1.0, 1.5, 2.0)
    damping_escalation_base: float = 2.0
    backoff_base_s: float = 0.0  # kept for parity; solver runs are fast on-device
    backoff_jitter_s: float = 0.0
    max_condition_number: float = 1e8
    min_diagonal: float = 1e-12
    enable_conditioning_gate: bool = True
    enable_regression_gate: bool = True
    max_cost_increase_ratio: float = 1.5
    max_iteration_increase: int = 10


@dataclass
class SolverSnapshot:
    digest: str
    attempt: int
    status: int
    converged: bool
    initial_cost: float
    final_cost: float
    iterations: int
    diagnostics: List[Dict[str, Any]] = field(default_factory=list)
    residual_histogram: Optional[Dict[str, Any]] = None
    conditioning: Optional[Dict[str, float]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclass
class RegressionVerdict:
    status: str  # "pass" | "regressed" | "no_baseline"
    reasons: List[str] = field(default_factory=list)


class SolverRegressionGate:
    """Compare each run against the previous one."""

    def __init__(self, config: OptimizationControlConfig) -> None:
        self.config = config
        self._last: Optional[SolverSnapshot] = None

    def check(self, snapshot: SolverSnapshot) -> RegressionVerdict:
        last = self._last
        self._last = snapshot
        if last is None:
            return RegressionVerdict(status="no_baseline")
        reasons = []
        if last.final_cost > 0 and snapshot.final_cost > last.final_cost * self.config.max_cost_increase_ratio:
            reasons.append(
                f"final_cost {snapshot.final_cost:.6g} > {self.config.max_cost_increase_ratio}x previous {last.final_cost:.6g}"
            )
        if snapshot.iterations > last.iterations + self.config.max_iteration_increase:
            reasons.append(
                f"iterations {snapshot.iterations} > previous {last.iterations} + {self.config.max_iteration_increase}"
            )
        return RegressionVerdict(status="regressed" if reasons else "pass", reasons=reasons)


@dataclass
class OptimizationRunReport:
    snapshot: SolverSnapshot
    attempts: int
    conditioning_tripped: bool
    regression: RegressionVerdict
    events: List[Dict[str, Any]] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "snapshot": self.snapshot.to_dict(),
            "attempts": self.attempts,
            "conditioning_tripped": self.conditioning_tripped,
            "regression": dataclasses.asdict(self.regression),
            "events": self.events,
        }


def problem_digest(problem: GraphProblem) -> str:
    """The reference's problem digest: x0 and measurements hashed as
    float32 arrays, edges as int32."""
    return stable_hash(
        {
            "model": problem.model_name,
            "n": problem.num_variables,
            "e": problem.num_factors,
            "x0": problem.x0.detach().cpu().numpy().astype(np.float32),
            "edges": problem.edges.detach().cpu().numpy().astype(np.int32),
            "meas": problem.measurements.detach().cpu().numpy().astype(np.float32),
        }
    )


class OptimizationSupervisor:
    """Supervised solving with escalation, gates and telemetry."""

    def __init__(
        self,
        config: Optional[OptimizationControlConfig] = None,
        registry: Optional[SolverRegistry] = None,
        clock=time.time,
    ) -> None:
        self.config = config or OptimizationControlConfig()
        self.registry = registry or DEFAULT_REGISTRY
        self.clock = clock
        self.regression_gate = SolverRegressionGate(self.config)
        self.events: List[Dict[str, Any]] = []
        self._runs = 0
        self._failures = 0
        self._cost_stats = StreamingMoments()
        self._iter_stats = StreamingMoments()
        self.last_report: Optional[OptimizationRunReport] = None

    def _emit(self, event_type: str, **metadata) -> None:
        self.events.append({"timestamp_s": self.clock(), "type": event_type, "metadata": metadata})

    def run(
        self,
        problem: GraphProblem,
        solver_name: str = "gauss_newton",
        config: Optional[SolverConfig] = None,
    ) -> SolverResult:
        config = config or SolverConfig()
        self._runs += 1
        digest = problem_digest(problem)

        conditioning = None
        tripped = False
        if self.config.enable_conditioning_gate and problem.num_factors > 0:
            conditioning = conditioning_stats(problem, damping=config.damping)
            if (
                conditioning["condition_number"] > self.config.max_condition_number
                or conditioning["min_diagonal"] < self.config.min_diagonal
            ):
                self._failures += 1
                self._emit("conditioning_gate_tripped", **conditioning)
                snapshot = SolverSnapshot(
                    digest=digest, attempt=0, status=-2, converged=False, initial_cost=0.0,
                    final_cost=0.0, iterations=0, conditioning=conditioning,
                )
                self.last_report = OptimizationRunReport(
                    snapshot=snapshot,
                    attempts=0,
                    conditioning_tripped=True,
                    regression=RegressionVerdict(status="no_baseline"),
                    events=list(self.events),
                )
                return SolverResult(
                    x=problem.x0.detach().cpu().numpy(), initial_cost=0.0, final_cost=0.0,
                    iterations=0, converged=False, status=-2,
                )

        solver = self.registry.get(solver_name)
        result: Optional[SolverResult] = None
        attempt = 0
        for attempt in range(1, self.config.max_attempts + 1):
            scale_mult = self.config.loss_scale_escalation[
                min(attempt - 1, len(self.config.loss_scale_escalation) - 1)
            ]
            attempt_config = dataclasses.replace(
                config,
                loss_scale=config.loss_scale * scale_mult,
                damping=config.damping * (self.config.damping_escalation_base ** (attempt - 1)),
            )
            self._emit(
                "solver_attempt", attempt=attempt, loss_scale=attempt_config.loss_scale,
                damping=attempt_config.damping,
            )
            result = solver.solve(problem, attempt_config)
            if result.converged or result.final_cost <= result.initial_cost + 1e-12:
                break
            self._emit("solver_retry", attempt=attempt, final_cost=result.final_cost)
            if self.config.backoff_base_s > 0:
                time.sleep(self.config.backoff_base_s * attempt + random.random() * self.config.backoff_jitter_s)

        assert result is not None
        self._cost_stats.update(result.final_cost)
        self._iter_stats.update(result.iterations)
        if not result.converged and result.final_cost > result.initial_cost:
            self._failures += 1

        snapshot = SolverSnapshot(
            digest=digest,
            attempt=attempt,
            status=result.status,
            converged=result.converged,
            initial_cost=result.initial_cost,
            final_cost=result.final_cost,
            iterations=result.iterations,
            diagnostics=[dataclasses.asdict(d) for d in result.diagnostics],
            residual_histogram=result.residual_histogram.to_dict() if result.residual_histogram else None,
            conditioning=conditioning,
        )
        regression = (
            self.regression_gate.check(snapshot)
            if self.config.enable_regression_gate
            else RegressionVerdict(status="no_baseline")
        )
        if regression.status == "regressed":
            self._emit("solver_regression", reasons=regression.reasons)
        self._emit("solver_complete", attempt=attempt, final_cost=result.final_cost)
        self.last_report = OptimizationRunReport(
            snapshot=snapshot,
            attempts=attempt,
            conditioning_tripped=tripped,
            regression=regression,
            events=list(self.events),
        )
        return result

    def health_snapshot(self) -> Dict[str, Any]:
        return {
            "stage": "optimization",
            "runs": self._runs,
            "failures": self._failures,
            "failure_ratio": self._failures / max(self._runs, 1),
            "cost": self._cost_stats.summary(),
            "iterations": self._iter_stats.summary(),
            "event_digest": stable_event_digest(self.events),
        }
