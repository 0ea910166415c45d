"""Telemetry analysis: streaming digests, flattened metrics, drift policies.

Parity: reference ``telemetry_intelligence.py`` — ``TelemetryDigest``
(streaming Welford + P² quantiles per stage for durations and memory
deltas, ref L198-391), ``summarize_telemetry_streaming`` over event files
(ref L419-429), flattening to ``telemetry_stage_*`` metrics for baseline
gating (ref L444-493), and drift evaluation via relative/absolute
increase policies composed by a ``TelemetryDriftEvaluator`` producing
pass/warn/fail per stage-metric (ref L68-195, L496-507).

Copied close to verbatim from ``mvslam_tpu/eval/telemetry_intelligence.py``: it needs numpy only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional

from mvslam_tpu_torch.core.persistence import StreamingMoments, iter_json_array_items


class TelemetryDigest:
    """Streaming per-stage statistics (never holds full event logs)."""

    def __init__(self) -> None:
        self._durations: Dict[str, StreamingMoments] = {}
        self._memory: Dict[str, StreamingMoments] = {}
        self._errors: Dict[str, int] = {}
        self.total_events = 0

    def update(self, event: Mapping[str, Any]) -> None:
        name = str(event.get("name", "unknown"))
        self.total_events += 1
        self._durations.setdefault(name, StreamingMoments()).update(
            float(event.get("duration_s", 0.0))
        )
        meta = event.get("metadata") or {}
        mem = meta.get("memory_delta_bytes")
        if mem is not None:
            self._memory.setdefault(name, StreamingMoments()).update(float(mem))
        if meta.get("success") is False:
            self._errors[name] = self._errors.get(name, 0) + 1

    def summary(self) -> Dict[str, Any]:
        return {
            "total_events": self.total_events,
            "stages": {
                name: {
                    "duration_s": stats.summary(),
                    **(
                        {"memory_delta_bytes": self._memory[name].summary()}
                        if name in self._memory
                        else {}
                    ),
                    "errors": self._errors.get(name, 0),
                }
                for name, stats in sorted(self._durations.items())
            },
        }


def summarize_telemetry_streaming(path: Path) -> Dict[str, Any]:
    """Stream a telemetry JSON array file into a digest summary.

    Parity: ``telemetry_intelligence.py:419-429``.
    """
    digest = TelemetryDigest()
    for event in iter_json_array_items(Path(path)):
        digest.update(event)
    return digest.summary()


def flatten_stage_metrics(summary: Mapping[str, Any]) -> Dict[str, float]:
    """``telemetry_stage_{stage}_{field}`` flat metrics for baseline gating.

    Parity: ``telemetry_intelligence.py:444-493``.
    """
    out: Dict[str, float] = {}
    for stage, stats in (summary.get("stages") or {}).items():
        dur = stats.get("duration_s", {})
        for key in ("mean", "p95", "max", "count"):
            if key in dur:
                out[f"telemetry_stage_{stage}_duration_{key}"] = float(dur[key])
        mem = stats.get("memory_delta_bytes")
        if mem:
            out[f"telemetry_stage_{stage}_memory_mean"] = float(mem.get("mean", 0.0))
        out[f"telemetry_stage_{stage}_errors"] = float(stats.get("errors", 0))
    return out


# ---------------------------------------------------------------------------
# Drift policies
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DriftVerdict:
    metric: str
    status: str  # "pass" | "warn" | "fail"
    current: float
    baseline: float
    detail: str = ""


@dataclass(frozen=True)
class RelativeIncreasePolicy:
    """Fail when current > baseline · (1 + fail); warn above (1 + warn).

    Parity: ``telemetry_intelligence.py:68-130``.
    """

    warn_ratio: float = 0.25
    fail_ratio: float = 0.5

    def evaluate(self, metric: str, current: float, baseline: float) -> DriftVerdict:
        if baseline <= 0:
            return DriftVerdict(metric, "pass", current, baseline, "no positive baseline")
        ratio = current / baseline - 1.0
        if ratio > self.fail_ratio:
            return DriftVerdict(metric, "fail", current, baseline, f"+{ratio:.1%} > {self.fail_ratio:.0%}")
        if ratio > self.warn_ratio:
            return DriftVerdict(metric, "warn", current, baseline, f"+{ratio:.1%} > {self.warn_ratio:.0%}")
        return DriftVerdict(metric, "pass", current, baseline)


@dataclass(frozen=True)
class AbsoluteIncreasePolicy:
    """Fail when current − baseline exceeds an absolute budget.

    Parity: ``telemetry_intelligence.py:133-195``.
    """

    warn_delta: float
    fail_delta: float

    def evaluate(self, metric: str, current: float, baseline: float) -> DriftVerdict:
        delta = current - baseline
        if delta > self.fail_delta:
            return DriftVerdict(metric, "fail", current, baseline, f"+{delta:.4g} > {self.fail_delta:.4g}")
        if delta > self.warn_delta:
            return DriftVerdict(metric, "warn", current, baseline, f"+{delta:.4g} > {self.warn_delta:.4g}")
        return DriftVerdict(metric, "pass", current, baseline)


@dataclass
class TelemetryDriftReport:
    verdicts: List[DriftVerdict] = field(default_factory=list)

    @property
    def status(self) -> str:
        statuses = {v.status for v in self.verdicts}
        if "fail" in statuses:
            return "fail"
        if "warn" in statuses:
            return "warn"
        return "pass"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "status": self.status,
            "verdicts": [v.__dict__ for v in self.verdicts],
        }


class TelemetryDriftEvaluator:
    """Compose per-metric policies over flattened stage metrics.

    Parity: ``telemetry_intelligence.py:496-507``.
    """

    def __init__(
        self,
        default_policy: Optional[RelativeIncreasePolicy] = None,
        metric_policies: Optional[Mapping[str, Any]] = None,
        only_metrics: Optional[Iterable[str]] = None,
    ) -> None:
        self.default_policy = default_policy or RelativeIncreasePolicy()
        self.metric_policies = dict(metric_policies or {})
        self.only_metrics = set(only_metrics) if only_metrics else None

    def evaluate(
        self, current: Mapping[str, float], baseline: Mapping[str, float]
    ) -> TelemetryDriftReport:
        report = TelemetryDriftReport()
        for metric in sorted(baseline):
            if self.only_metrics is not None and metric not in self.only_metrics:
                continue
            if metric not in current:
                continue
            policy = self.metric_policies.get(metric, self.default_policy)
            report.verdicts.append(
                policy.evaluate(metric, float(current[metric]), float(baseline[metric]))
            )
        return report
