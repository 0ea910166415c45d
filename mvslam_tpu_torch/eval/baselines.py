"""Regression baseline store + metric comparison.

Parity: reference ``regression_baselines.py`` — JSON store
``{"baselines": {key: {metrics, config_hash, updated_at}}}`` (ref L42-70)
and ``compare_metrics`` with ``MetricThreshold{max/min_delta,
max/min_ratio}`` plus the ``direction`` + ``tolerance`` sugar (ref
L73-182), yielding pass/regressed/missing_baseline per metric.

Copied close to verbatim from ``mvslam_tpu/eval/baselines.py``: it imports no JAX.
"""

from __future__ import annotations

import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Mapping, Optional


@dataclass(frozen=True)
class MetricThreshold:
    """Parity: ``regression_baselines.py:73-110``."""

    max_delta: Optional[float] = None
    min_delta: Optional[float] = None
    max_ratio: Optional[float] = None
    min_ratio: Optional[float] = None
    direction: Optional[str] = None  # "lower" | "higher" (sugar)
    tolerance: float = 0.0

    @classmethod
    def from_config(cls, payload) -> "MetricThreshold":
        if isinstance(payload, MetricThreshold):
            return payload
        return cls(**dict(payload))


@dataclass
class MetricComparison:
    metric: str
    status: str  # "pass" | "regressed" | "missing_baseline"
    current: Optional[float] = None
    baseline: Optional[float] = None
    reasons: List[str] = field(default_factory=list)


@dataclass
class ComparisonReport:
    comparisons: List[MetricComparison] = field(default_factory=list)

    @property
    def status(self) -> str:
        statuses = [c.status for c in self.comparisons]
        if "regressed" in statuses:
            return "regressed"
        if "missing_baseline" in statuses:
            return "missing_baseline"
        return "pass"

    def to_dict(self) -> Dict:
        return {
            "status": self.status,
            "comparisons": [c.__dict__ for c in self.comparisons],
        }


def compare_metrics(
    current: Mapping[str, float],
    baseline: Optional[Mapping[str, float]],
    thresholds: Mapping[str, MetricThreshold],
) -> ComparisonReport:
    """Parity: ``regression_baselines.py:112-182``."""
    report = ComparisonReport()
    for metric in sorted(thresholds):
        threshold = MetricThreshold.from_config(thresholds[metric])
        cur = current.get(metric)
        base = None if baseline is None else baseline.get(metric)
        if cur is None or base is None or (isinstance(base, float) and math.isnan(base)):
            report.comparisons.append(
                MetricComparison(metric, "missing_baseline", cur, base)
            )
            continue
        cur = float(cur)
        base = float(base)
        reasons: List[str] = []
        delta = cur - base
        ratio = cur / base if base != 0 else math.inf if cur > 0 else 1.0
        if threshold.direction == "lower":
            # metric should not increase beyond tolerance (relative)
            limit = base * (1.0 + threshold.tolerance) + 1e-12
            if cur > limit:
                reasons.append(f"{cur:.6g} > {limit:.6g} (direction=lower, tol={threshold.tolerance})")
        elif threshold.direction == "higher":
            limit = base * (1.0 - threshold.tolerance) - 1e-12
            if cur < limit:
                reasons.append(f"{cur:.6g} < {limit:.6g} (direction=higher, tol={threshold.tolerance})")
        if threshold.max_delta is not None and delta > threshold.max_delta:
            reasons.append(f"delta {delta:.6g} > max_delta {threshold.max_delta}")
        if threshold.min_delta is not None and delta < threshold.min_delta:
            reasons.append(f"delta {delta:.6g} < min_delta {threshold.min_delta}")
        if threshold.max_ratio is not None and ratio > threshold.max_ratio:
            reasons.append(f"ratio {ratio:.6g} > max_ratio {threshold.max_ratio}")
        if threshold.min_ratio is not None and ratio < threshold.min_ratio:
            reasons.append(f"ratio {ratio:.6g} < min_ratio {threshold.min_ratio}")
        report.comparisons.append(
            MetricComparison(
                metric, "regressed" if reasons else "pass", cur, base, reasons
            )
        )
    return report


class BaselineStore:
    """JSON-file baseline store. Parity: ``regression_baselines.py:42-70``."""

    def __init__(self, path: Path) -> None:
        self.path = Path(path)

    def _load(self) -> Dict:
        if not self.path.exists():
            return {"baselines": {}}
        return json.loads(self.path.read_text())

    def load_baseline(self, key: str) -> Optional[Dict[str, float]]:
        entry = self._load()["baselines"].get(key)
        return None if entry is None else dict(entry.get("metrics", {}))

    def upsert_baseline(
        self, key: str, metrics: Mapping[str, float], config_hash: str = ""
    ) -> None:
        payload = self._load()
        payload["baselines"][key] = {
            "metrics": dict(metrics),
            "config_hash": config_hash,
            "updated_at": time.time(),
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(payload, indent=2, sort_keys=True))

    def keys(self) -> List[str]:
        return sorted(self._load()["baselines"])


def upsert_baseline(path: Path, key: str, metrics: Mapping[str, float], config_hash: str = "") -> None:
    BaselineStore(path).upsert_baseline(key, metrics, config_hash)
