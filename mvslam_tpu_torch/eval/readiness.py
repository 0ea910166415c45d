"""Readiness report: roll up control-plane + evaluation + telemetry state.

Parity: reference ``readiness_report.py`` — merges a control-plane
report, an evaluation summary, and a telemetry summary into a single
artifact with pass/warn/fail/unknown status per section, an overall
rollup, and a stable digest (ref L96-301).

Copied close to verbatim from ``mvslam_tpu/eval/readiness.py``: it imports no JAX.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

from mvslam_tpu_torch.core.integrity import stable_hash

_STATUS_ORDER = {"pass": 0, "unknown": 1, "warn": 2, "fail": 3}


def _worst(statuses: List[str]) -> str:
    return max(statuses, key=lambda s: _STATUS_ORDER.get(s, 1)) if statuses else "unknown"


def _section_from_control_plane(report: Mapping[str, Any]) -> Dict[str, Any]:
    stages = report.get("stages", report.get("health", {}))
    statuses = []
    details = {}
    for name, snap in (stages or {}).items():
        state = str(snap.get("state", snap.get("status", "unknown"))).lower()
        status = {
            "healthy": "pass",
            "degraded": "warn",
            "tripped": "fail",
            "recovering": "warn",
        }.get(state, "unknown")
        statuses.append(status)
        details[name] = {"state": state, "status": status}
    return {"status": _worst(statuses), "stages": details}


def _section_from_evaluation(summary: Mapping[str, Any]) -> Dict[str, Any]:
    status = str(summary.get("status", "unknown"))
    mapped = {"pass": "pass", "regressed": "fail", "missing_baseline": "warn"}.get(status, "unknown")
    return {"status": mapped, "aggregate": summary.get("aggregate", {})}


def _section_from_telemetry(summary: Mapping[str, Any]) -> Dict[str, Any]:
    stages = summary.get("stages", {})
    errors = sum(int(s.get("errors", 0)) for s in stages.values())
    status = "pass" if errors == 0 else ("warn" if errors < 5 else "fail")
    return {"status": status, "total_events": summary.get("total_events", 0), "errors": errors}


def generate_readiness_report(
    control_plane_report: Optional[Mapping[str, Any]] = None,
    evaluation_summary: Optional[Mapping[str, Any]] = None,
    telemetry_summary: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """Parity: ``readiness_report.py:233-285``."""
    sections: Dict[str, Any] = {}
    if control_plane_report is not None:
        sections["control_plane"] = _section_from_control_plane(control_plane_report)
    else:
        sections["control_plane"] = {"status": "unknown"}
    if evaluation_summary is not None:
        sections["evaluation"] = _section_from_evaluation(evaluation_summary)
    else:
        sections["evaluation"] = {"status": "unknown"}
    if telemetry_summary is not None:
        sections["telemetry"] = _section_from_telemetry(telemetry_summary)
    else:
        sections["telemetry"] = {"status": "unknown"}
    overall = _worst([s["status"] for s in sections.values()])
    report = {"status": overall, "sections": sections}
    report["digest"] = stable_hash(report)
    return report


def run_readiness_report(
    control_plane_path: Optional[Path] = None,
    evaluation_path: Optional[Path] = None,
    telemetry_path: Optional[Path] = None,
    out_path: Optional[Path] = None,
) -> Dict[str, Any]:
    """Parity: ``readiness_report.py:296-301``."""

    def load(path: Optional[Path]):
        return json.loads(Path(path).read_text()) if path and Path(path).exists() else None

    report = generate_readiness_report(
        load(control_plane_path), load(evaluation_path), load(telemetry_path)
    )
    if out_path is not None:
        Path(out_path).write_text(json.dumps(report, indent=2, sort_keys=True))
    return report


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Generate a readiness report")
    parser.add_argument("--control-plane", type=Path, default=None)
    parser.add_argument("--evaluation", type=Path, default=None)
    parser.add_argument("--telemetry", type=Path, default=None)
    parser.add_argument("--out", type=Path, default=Path("readiness_report.json"))
    args = parser.parse_args(argv)
    report = run_readiness_report(args.control_plane, args.evaluation, args.telemetry, args.out)
    print(json.dumps({"status": report["status"]}))
    return 0 if report["status"] in ("pass", "warn") else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
