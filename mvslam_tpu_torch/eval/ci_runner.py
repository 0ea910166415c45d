"""CI benchmark suite: regression gate + severity scoring.

Parity: reference ``benchmark_ci_runner.py`` — runs the gate, then scores
each regressed metric with a normalised threshold-exceedance penalty,
RMS-combined and weighted per metric class (ATE_RMSE 2.0, RPE 1.5 in the
reference's ci_benchmark.json — ref L33-40, L128-169); writes
``ci_benchmark_summary.json``.

Copied close to verbatim from ``mvslam_tpu/eval/ci_runner.py``: it imports no JAX.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

from mvslam_tpu_torch.eval.regression_gate import execute_gate


@dataclass(frozen=True)
class SeverityWeights:
    """Parity: ``benchmark_ci_runner.py:33-40``."""

    weights: Mapping[str, float] = field(
        default_factory=lambda: {"ATE_RMSE": 2.0, "RPE_RMSE": 1.5}
    )
    default: float = 1.0

    def weight_for(self, metric: str) -> float:
        for key, w in self.weights.items():
            if metric.startswith(key):
                return float(w)
        return self.default


def metric_severity(
    comparison: Mapping[str, Any], weights: SeverityWeights
) -> float:
    """Normalised exceedance penalty for one regressed metric comparison.

    Parity: ``benchmark_ci_runner.py:143-169``.
    """
    if comparison.get("status") != "regressed":
        return 0.0
    current = comparison.get("current")
    baseline = comparison.get("baseline")
    if current is None or baseline is None or baseline == 0:
        exceedance = 1.0
    else:
        exceedance = abs(float(current) - float(baseline)) / abs(float(baseline))
    return weights.weight_for(str(comparison.get("metric", ""))) * min(exceedance, 10.0)


def score_run(run_detail: Mapping[str, Any], weights: SeverityWeights) -> float:
    """RMS-combined severity of all regressed comparisons in a run summary."""
    comparisons: List[Mapping[str, Any]] = []
    for section in (run_detail.get("baseline_comparisons") or {}).values():
        comparisons.extend(section.get("comparisons", []))
    penalties = [metric_severity(c, weights) for c in comparisons]
    penalties = [p for p in penalties if p > 0]
    if not penalties:
        return 0.0
    return math.sqrt(sum(p * p for p in penalties) / len(penalties))


async def run_ci_suite(
    config_paths: List[Path],
    weights: Optional[SeverityWeights] = None,
    max_concurrency: int = 2,
    governance_config: Optional[Path] = None,
) -> Dict[str, Any]:
    """Accuracy gate + optional PERF gate in one CI verdict.

    ``governance_config`` (VERDICT r3 item 4): a ``eval.governance`` config
    (e.g. ``configs/evaluation/perf_gate.json``) whose benchmark metrics are
    compared against a committed baseline store — a kernel/pipeline perf
    regression then fails CI exactly like an ATE regression. Parity: the
    reference separates these layers too (``benchmark_ci_runner.py`` over
    ``benchmark_governance.py``); here they roll into one suite status.
    """
    weights = weights or SeverityWeights()
    gate = await execute_gate(config_paths, max_concurrency, fail_fast=False)
    # Re-load run summaries for severity scoring.
    runs = []
    total_severity = 0.0
    for run in gate["runs"]:
        severity = 0.0
        run_dir = run.get("run_dir")
        if run_dir:
            summary_path = Path(run_dir) / "summary.json"
            if summary_path.exists():
                severity = score_run(json.loads(summary_path.read_text()), weights)
        total_severity += severity
        runs.append({**run, "severity": severity})
    summary: Dict[str, Any] = {
        "status": gate["status"],
        "total_severity": total_severity,
        "runs": runs,
    }
    if governance_config is not None:
        from mvslam_tpu_torch.eval.governance import load_governance_config, run_governance

        perf = run_governance(load_governance_config(governance_config))
        # Perf regressions carry severity like metric regressions do.
        perf_severity = 0.0
        for bench in perf["benchmarks"]:
            comparison = bench.get("baseline_comparison")
            if comparison:
                perf_severity += math.sqrt(
                    sum(
                        metric_severity(c, weights) ** 2
                        for c in comparison.get("comparisons", [])
                    )
                    or 0.0
                )
        summary["perf_gate"] = perf
        summary["total_severity"] += perf_severity
        if perf["status"] != "pass" and summary["status"] == "pass":
            summary["status"] = perf["status"]
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="CI benchmark suite with severity scoring")
    parser.add_argument("configs", nargs="+", type=Path)
    parser.add_argument("--max-concurrency", type=int, default=2)
    parser.add_argument("--summary-out", type=Path, default=Path("ci_benchmark_summary.json"))
    parser.add_argument(
        "--governance-config",
        type=Path,
        default=None,
        help="optional eval.governance config (perf gate, e.g. "
        "configs/evaluation/perf_gate.json) merged into the suite verdict",
    )
    args = parser.parse_args(argv)
    summary = asyncio.run(
        run_ci_suite(
            args.configs,
            max_concurrency=args.max_concurrency,
            governance_config=args.governance_config,
        )
    )
    args.summary_out.write_text(json.dumps(summary, indent=2, sort_keys=True))
    print(json.dumps({"status": summary["status"], "total_severity": summary["total_severity"]}))
    return 0 if summary["status"] == "pass" else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
