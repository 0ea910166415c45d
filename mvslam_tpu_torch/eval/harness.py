"""Config-driven evaluation harness.

Parity: reference ``evaluation_harness.py`` — normalises flat or
``{run, pipeline, evaluation, baseline}`` config schemas (ref L147-180),
builds entries from explicit trajectory lists or run-dir artifacts (est
``.txt`` or run-dir npz, ref L118-212), computes per-sequence ATE/RPE +
streaming telemetry summary + frame-diagnostics summary + relocalization
merge (ref L468-564), aggregates (mean over sequences, ref L386-398),
performs the three baseline comparisons (metrics / telemetry /
relocalization) with optional ``write`` upsert (ref L633-767), evaluates
telemetry drift vs the stored baseline summary (ref L570-610), and writes
``summary.json`` / ``summary.csv`` (ref L769-771). CLI entry point:
``python -m mvslam_tpu_torch.eval.harness --config cfg.json``.

Copied close to verbatim from ``mvslam_tpu/eval/harness.py``: it imports no JAX.
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional

import numpy as np

from mvslam_tpu_torch.core.determinism import build_registry
from mvslam_tpu_torch.core.experiments import create_run_artifacts, write_resolved_config
from mvslam_tpu_torch.core.persistence import (
    sanitize_artifact_name,
    summarize_frame_diagnostics_streaming,
)
from mvslam_tpu_torch.eval.baselines import BaselineStore, MetricThreshold, compare_metrics
from mvslam_tpu_torch.eval.relocalization_metrics import (
    summarize_relocalization_events,
    summarize_relocalized_frames,
)
from mvslam_tpu_torch.eval.telemetry_intelligence import (
    TelemetryDriftEvaluator,
    flatten_stage_metrics,
    summarize_telemetry_streaming,
)
from mvslam_tpu_torch.eval.trajectory import (
    compute_additional_metrics,
    load_trajectory_file,
    positions_from_poses,
    write_metrics_csv,
    write_metrics_json,
    write_metrics_txt,
)

logger = logging.getLogger(__name__)


@dataclass
class EvaluationEntry:
    name: str
    gt_path: Path
    gt_format: str = "kitti_odom"
    est_path: Optional[Path] = None  # txt trajectory
    est_format: str = "kitti_odom"
    est_run_dir: Optional[Path] = None  # run dir with npz artifacts
    est_trajectory_name: str = "estimated"


@dataclass
class EvaluationConfig:
    run_id: str = "evaluation"
    output_root: Path = Path("runs")
    seed: int = 0
    rpe_delta: int = 1
    entries: List[EvaluationEntry] = field(default_factory=list)
    baseline_store: Optional[Path] = None
    baseline_key: Optional[str] = None
    metric_thresholds: Dict[str, MetricThreshold] = field(default_factory=dict)
    telemetry_thresholds: Dict[str, MetricThreshold] = field(default_factory=dict)
    relocalization_thresholds: Dict[str, MetricThreshold] = field(default_factory=dict)
    write_baseline: bool = False


def load_config(path: Path) -> EvaluationConfig:
    """Normalise flat or structured schemas. Parity: ``evaluation_harness.py:147-337``."""
    payload = json.loads(Path(path).read_text())
    if {"run", "evaluation"} & set(payload):
        run = payload.get("run", {})
        evaluation = payload.get("evaluation", {})
        baseline = payload.get("baseline", {})
    else:
        run, evaluation, baseline = payload, payload, payload

    def thresholds(section: Mapping) -> Dict[str, MetricThreshold]:
        return {
            k: MetricThreshold.from_config(v)
            for k, v in (section or {}).items()
        }

    base = Path(path).parent
    entries = []
    for item in evaluation.get("trajectories", evaluation.get("sequences", [])):
        entries.append(
            EvaluationEntry(
                name=item["name"],
                gt_path=base / item["gt"],
                gt_format=item.get("gt_format", "kitti_odom"),
                est_path=(base / item["est"]) if "est" in item else None,
                est_format=item.get("est_format", "kitti_odom"),
                est_run_dir=(base / item["est_run_dir"]) if "est_run_dir" in item else None,
                est_trajectory_name=item.get("est_trajectory_name", "estimated"),
            )
        )
    return EvaluationConfig(
        run_id=run.get("run_id", "evaluation"),
        output_root=Path(run.get("output_root", "runs")),
        seed=int(run.get("seed", 0)),
        rpe_delta=int(evaluation.get("rpe_delta", 1)),
        entries=entries,
        baseline_store=(base / baseline["store"]) if baseline.get("store") else None,
        baseline_key=baseline.get("key"),
        metric_thresholds=thresholds(baseline.get("metric_thresholds")),
        telemetry_thresholds=thresholds(baseline.get("telemetry_thresholds")),
        relocalization_thresholds=thresholds(baseline.get("relocalization_thresholds")),
        write_baseline=bool(baseline.get("write", False)),
    )


def _load_est_positions(entry: EvaluationEntry) -> np.ndarray:
    if entry.est_path is not None:
        return load_trajectory_file(entry.est_path, entry.est_format)
    if entry.est_run_dir is not None:
        npz = Path(entry.est_run_dir) / "trajectories" / f"{entry.est_trajectory_name}.npz"
        with np.load(npz, allow_pickle=False) as data:
            return positions_from_poses(np.asarray(data["poses"]))
    raise ValueError(f"entry {entry.name!r} has neither est path nor run dir")


def _run_dir_artifacts(entry: EvaluationEntry) -> Dict[str, Any]:
    """Streaming telemetry/diagnostics/relocalization summaries from a run dir."""
    out: Dict[str, Any] = {}
    if entry.est_run_dir is None:
        return out
    run_dir = Path(entry.est_run_dir)
    telem = run_dir / "telemetry" / "events.json"
    if telem.exists():
        out["telemetry_summary"] = summarize_telemetry_streaming(telem)
        from mvslam_tpu_torch.core.persistence import iter_json_array_items

        out["relocalization_events"] = summarize_relocalization_events(
            iter_json_array_items(telem)
        )
    diag = run_dir / "diagnostics" / "frame_diagnostics.json"
    if diag.exists():
        out["frame_diagnostics_summary"] = summarize_frame_diagnostics_streaming(diag)
        from mvslam_tpu_torch.core.persistence import iter_json_array_items

        out["relocalization_frames"] = summarize_relocalized_frames(
            iter_json_array_items(diag)
        )
    return out


def run_evaluation(config: EvaluationConfig) -> Dict[str, Any]:
    """Parity: ``evaluation_harness.py:468-772``."""
    registry = build_registry(config.seed)
    registry.apply_global_seed()
    arts = create_run_artifacts(config.output_root, config.run_id, metadata=registry.metadata())
    write_resolved_config(arts.run_dir, {"run_id": config.run_id, "seed": config.seed})

    per_sequence: Dict[str, Dict[str, Any]] = {}
    telemetry_flat_all: Dict[str, float] = {}
    reloc_all: Dict[str, float] = {}
    for entry in config.entries:
        gt = load_trajectory_file(entry.gt_path, entry.gt_format)
        est = _load_est_positions(entry)
        metrics = compute_additional_metrics(est, gt, config.rpe_delta)
        extras = _run_dir_artifacts(entry)
        seq_report: Dict[str, Any] = {"metrics": metrics, **extras}
        if "telemetry_summary" in extras:
            flat = flatten_stage_metrics(extras["telemetry_summary"])
            seq_report["telemetry_metrics"] = flat
            telemetry_flat_all.update(flat)
        for source in ("relocalization_events", "relocalization_frames"):
            for k, v in (extras.get(source) or {}).items():
                if isinstance(v, (int, float)):
                    reloc_all[f"{source}_{k}"] = float(v)
        per_sequence[entry.name] = seq_report
        # Per-sequence report files via the trajectory writers (parity:
        # evaluation_harness.py:561-564 writes txt/json/csv per sequence).
        seq_dir = arts.run_dir / "sequences"
        seq_dir.mkdir(exist_ok=True)
        safe = sanitize_artifact_name(entry.name)
        write_metrics_txt(metrics, seq_dir / f"{safe}.txt")
        write_metrics_json(metrics, seq_dir / f"{safe}.json")
        write_metrics_csv(metrics, seq_dir / f"{safe}.csv")

    # Aggregate: mean over sequences (parity L386-398).
    aggregate: Dict[str, float] = {}
    if per_sequence:
        keys = set()
        for report in per_sequence.values():
            keys |= set(report["metrics"])
        for key in sorted(keys):
            values = [r["metrics"][key] for r in per_sequence.values() if key in r["metrics"]]
            aggregate[key] = float(np.mean(values))

    summary: Dict[str, Any] = {
        "run_id": config.run_id,
        "determinism": registry.metadata(),
        "sequences": per_sequence,
        "aggregate": aggregate,
    }

    # Baseline comparisons x3 + optional upsert (parity L633-767).
    if config.baseline_store and config.baseline_key:
        store = BaselineStore(config.baseline_store)
        sections = [
            ("metrics", aggregate, config.metric_thresholds, config.baseline_key),
            ("telemetry", telemetry_flat_all, config.telemetry_thresholds, f"{config.baseline_key}_telemetry"),
            ("relocalization", reloc_all, config.relocalization_thresholds, f"{config.baseline_key}_relocalization"),
        ]
        comparisons: Dict[str, Any] = {}
        for name, current, thresholds, key in sections:
            if not thresholds:
                continue
            baseline = store.load_baseline(key)
            comparisons[name] = compare_metrics(current, baseline, thresholds).to_dict()
            if config.write_baseline:
                store.upsert_baseline(key, current, registry.config_hash)
        summary["baseline_comparisons"] = comparisons
        statuses = [c["status"] for c in comparisons.values()]
        summary["status"] = (
            "regressed"
            if "regressed" in statuses
            else ("missing_baseline" if "missing_baseline" in statuses else "pass")
        )
        # Telemetry drift report vs stored telemetry baseline (parity L570-610).
        telem_baseline = store.load_baseline(f"{config.baseline_key}_telemetry")
        if telem_baseline and telemetry_flat_all:
            drift = TelemetryDriftEvaluator().evaluate(telemetry_flat_all, telem_baseline)
            summary["telemetry_drift"] = drift.to_dict()
    else:
        summary["status"] = "pass"

    summary_path = arts.run_dir / "summary.json"
    summary_path.write_text(json.dumps(summary, indent=2, sort_keys=True, default=str))
    with open(arts.run_dir / "summary.csv", "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["metric", "value"])
        for k, v in sorted(aggregate.items()):
            writer.writerow([k, f"{v:.6f}"])
    summary["run_dir"] = str(arts.run_dir)
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Run the evaluation harness")
    parser.add_argument("--config", type=Path, required=True)
    parser.add_argument("--write-baseline", action="store_true")
    args = parser.parse_args(argv)
    config = load_config(args.config)
    if args.write_baseline:
        config.write_baseline = True
    summary = run_evaluation(config)
    print(json.dumps({"status": summary["status"], "aggregate": summary["aggregate"], "run_dir": summary["run_dir"]}, indent=2))
    return 0 if summary["status"] == "pass" else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
