"""Meta-benchmark governance: run benchmark subprocesses under budgets.

Parity: reference ``benchmark_governance.py`` — executes arbitrary
benchmark commands as subprocesses with runtime/memory budgets, parses
their emitted JSON metrics, compares against its own baseline store,
fail-fast, and writes a governance summary (ref L30-156).

Copied close to verbatim from ``mvslam_tpu/eval/governance.py``: it imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import resource
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

from mvslam_tpu_torch.eval.baselines import BaselineStore, MetricThreshold, compare_metrics


@dataclass(frozen=True)
class BenchmarkSpec:
    """Parity: ``benchmark_governance.py:37-43``."""

    name: str
    command: List[str]
    runtime_budget_s: Optional[float] = None
    memory_budget_bytes: Optional[int] = None
    metric_thresholds: Dict[str, MetricThreshold] = field(default_factory=dict)


def load_governance_config(path: Path) -> Dict[str, Any]:
    """Parity: ``benchmark_governance.py:112-156``."""
    payload = json.loads(Path(path).read_text())
    specs = [
        BenchmarkSpec(
            name=item["name"],
            command=list(item["command"]),
            runtime_budget_s=item.get("runtime_budget_s"),
            memory_budget_bytes=item.get("memory_budget_bytes"),
            metric_thresholds={
                k: MetricThreshold.from_config(v)
                for k, v in item.get("metric_thresholds", {}).items()
            },
        )
        for item in payload.get("benchmarks", [])
    ]
    return {
        "specs": specs,
        "baseline_store": payload.get("baseline_store"),
        "fail_fast": payload.get("fail_fast", True),
        "write_baseline": payload.get("write_baseline", False),
    }


def _parse_metrics(stdout: str) -> Dict[str, float]:
    """Last JSON object on stdout wins (benchmarks print one JSON line)."""
    metrics: Dict[str, float] = {}
    for line in stdout.splitlines():
        line = line.strip()
        if not (line.startswith("{") and line.endswith("}")):
            continue
        try:
            payload = json.loads(line)
        except json.JSONDecodeError:
            continue
        if isinstance(payload, dict):
            if "metric" in payload and "value" in payload:
                metrics[str(payload["metric"])] = float(payload["value"])
            else:
                for k, v in payload.items():
                    if isinstance(v, (int, float)):
                        metrics[str(k)] = float(v)
    return metrics


def run_benchmark(spec: BenchmarkSpec) -> Dict[str, Any]:
    start = time.perf_counter()
    try:
        proc = subprocess.run(
            spec.command,
            capture_output=True,
            text=True,
            timeout=spec.runtime_budget_s,
        )
        elapsed = time.perf_counter() - start
        peak_rss = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss * 1024
        result: Dict[str, Any] = {
            "name": spec.name,
            "status": "pass" if proc.returncode == 0 else "failed",
            "returncode": proc.returncode,
            "elapsed_s": elapsed,
            "peak_rss_bytes": peak_rss,
            "metrics": _parse_metrics(proc.stdout),
        }
        if proc.returncode != 0:
            result["stderr_tail"] = proc.stderr[-2000:]
        if spec.runtime_budget_s is not None and elapsed > spec.runtime_budget_s:
            result["status"] = "budget_exceeded"
            result["budget_violation"] = f"runtime {elapsed:.2f}s > {spec.runtime_budget_s}s"
        if spec.memory_budget_bytes is not None and peak_rss > spec.memory_budget_bytes:
            result["status"] = "budget_exceeded"
            result["budget_violation"] = (
                f"memory {peak_rss} > {spec.memory_budget_bytes} bytes"
            )
        return result
    except subprocess.TimeoutExpired:
        return {
            "name": spec.name,
            "status": "budget_exceeded",
            "budget_violation": f"runtime exceeded {spec.runtime_budget_s}s (killed)",
            "elapsed_s": time.perf_counter() - start,
            "metrics": {},
        }


def run_governance(config: Mapping[str, Any]) -> Dict[str, Any]:
    store = BaselineStore(Path(config["baseline_store"])) if config.get("baseline_store") else None
    results: List[Dict[str, Any]] = []
    overall = "pass"
    for spec in config["specs"]:
        result = run_benchmark(spec)
        if store is not None and spec.metric_thresholds and result["metrics"]:
            baseline = store.load_baseline(spec.name)
            comparison = compare_metrics(result["metrics"], baseline, spec.metric_thresholds)
            result["baseline_comparison"] = comparison.to_dict()
            if comparison.status == "regressed" and result["status"] == "pass":
                result["status"] = "regressed"
            if config.get("write_baseline"):
                store.upsert_baseline(spec.name, result["metrics"])
        results.append(result)
        if result["status"] != "pass":
            overall = result["status"]
            if config.get("fail_fast", True):
                break
    return {"status": overall, "benchmarks": results}


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Benchmark governance runner")
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--summary-out", type=Path, default=Path("governance_summary.json"))
    args = parser.parse_args(argv)
    config = load_governance_config(args.config)
    summary = run_governance(config)
    args.summary_out.write_text(json.dumps(summary, indent=2, sort_keys=True))
    print(json.dumps({"status": summary["status"]}))
    return 0 if summary["status"] == "pass" else 1


if __name__ == "__main__":
    sys.exit(main())
