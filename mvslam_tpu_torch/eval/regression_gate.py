"""Async regression gate over multiple evaluation configs.

Parity: reference ``benchmark_regression_gate.py`` — semaphore-bounded
asyncio execution of evaluation-harness configs with fail-fast
cancellation, pass/regressed/missing_baseline status per run, a
``regression_gate_summary.json`` artifact, and exit code 1 on any
non-pass (ref L69-181).

Copied close to verbatim from ``mvslam_tpu/eval/regression_gate.py``: it imports no JAX.
"""

from __future__ import annotations

import argparse
import asyncio
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

from mvslam_tpu_torch.eval.harness import load_config, run_evaluation


@dataclass
class GateRunResult:
    config: str
    status: str
    detail: Dict[str, Any] = field(default_factory=dict)


async def _run_one(config_path: Path, semaphore: asyncio.Semaphore) -> GateRunResult:
    async with semaphore:
        loop = asyncio.get_running_loop()

        def work():
            return run_evaluation(load_config(config_path))

        try:
            summary = await loop.run_in_executor(None, work)
            return GateRunResult(
                config=str(config_path),
                status=summary.get("status", "pass"),
                detail={"aggregate": summary.get("aggregate", {}), "run_dir": summary.get("run_dir")},
            )
        except Exception as exc:
            return GateRunResult(config=str(config_path), status="error", detail={"error": str(exc)})


async def execute_gate(
    config_paths: List[Path],
    max_concurrency: int = 2,
    fail_fast: bool = True,
) -> Dict[str, Any]:
    """Parity: ``benchmark_regression_gate.py:118-157``."""
    semaphore = asyncio.Semaphore(max_concurrency)
    tasks = [asyncio.ensure_future(_run_one(p, semaphore)) for p in config_paths]
    results: List[GateRunResult] = []
    try:
        for coro in asyncio.as_completed(tasks):
            result = await coro
            results.append(result)
            if fail_fast and result.status not in ("pass",):
                for t in tasks:
                    t.cancel()
                break
    finally:
        for t in tasks:
            if not t.done():
                t.cancel()
    statuses = [r.status for r in results]
    overall = "pass"
    for bad in ("error", "regressed", "missing_baseline"):
        if bad in statuses:
            overall = bad
            break
    return {
        "status": overall,
        "runs": [{"config": r.config, "status": r.status, **r.detail} for r in results],
        "completed": len(results),
        "requested": len(config_paths),
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Regression gate over evaluation configs")
    parser.add_argument("configs", nargs="+", type=Path)
    parser.add_argument("--max-concurrency", type=int, default=2)
    parser.add_argument("--no-fail-fast", action="store_true")
    parser.add_argument("--summary-out", type=Path, default=Path("regression_gate_summary.json"))
    args = parser.parse_args(argv)
    summary = asyncio.run(
        execute_gate(args.configs, args.max_concurrency, fail_fast=not args.no_fail_fast)
    )
    args.summary_out.write_text(json.dumps(summary, indent=2, sort_keys=True))
    print(json.dumps({"status": summary["status"], "completed": summary["completed"]}))
    return 0 if summary["status"] == "pass" else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
