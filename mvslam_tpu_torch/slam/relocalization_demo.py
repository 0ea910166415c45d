"""E2E relocalization scenario: run, inject loss, verify recovery, report.

Port of ``mvslam_tpu/slam/relocalization_demo.py``: run a KITTI sequence,
``inject_tracking_loss`` at frame N, verify the system relocalizes, and
write ``relocalization_demo_report.json`` with summary metrics consumed by
the evaluation harness. ``run_relocalization_demo(config, device="cuda")``
and ``--device`` carry the device.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

from mvslam_tpu_torch.eval.relocalization_metrics import (
    summarize_relocalization_events,
    summarize_relocalized_frames,
)

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class RelocalizationDemoConfig:
    """Parity: ``relocalization_demo.py:29-40``."""

    dataset_root: Path
    sequence: str = "00"
    inject_at_frame: int = 10
    max_frames: Optional[int] = 30
    run_id: str = "relocalization_demo"
    output_root: Path = Path("runs")
    seed: int = 0


def _build_demo_report(system, diagnostics, inject_at: int) -> Dict[str, Any]:
    """Parity: ``relocalization_demo.py:62-120``."""
    diag_dicts = [d.to_dict() for d in diagnostics]
    events = [e.to_dict() for e in system.telemetry.events()]
    injected = [d for d in diag_dicts if d.get("injected_loss")]
    relocalized = [d for d in diag_dicts if d.get("relocalized")]
    return {
        "inject_at_frame": inject_at,
        "injected_frames": [d["frame_id"] for d in injected],
        "relocalized_frames": [d["frame_id"] for d in relocalized],
        "recovered": bool(relocalized),
        "events_summary": summarize_relocalization_events(events),
        "frames_summary": summarize_relocalized_frames(diag_dicts),
    }


def run_relocalization_demo(config: RelocalizationDemoConfig, device="cuda") -> Dict[str, Any]:
    from mvslam_tpu_torch.backend.keyframes import KeyframeConfig
    from mvslam_tpu_torch.data.kitti import KittiSequence
    from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

    seq = KittiSequence(config.dataset_root, config.sequence)
    K = seq.camera_intrinsics()
    system = SLAMSystem(
        SLAMSystemConfig(
            run_id=config.run_id,
            output_root=config.output_root,
            seed=config.seed,
            fx=float(K[0, 0]),
            fy=float(K[1, 1]),
            cx=float(K[0, 2]),
            cy=float(K[1, 2]),
            keyframe=KeyframeConfig(min_translation=0.05),
            enable_relocalization=True,
        ),
        device=device,
    )
    system.inject_tracking_loss(config.inject_at_frame)
    diagnostics = system.run_stream(seq.iter_frames(config.max_frames))
    result = system.finalize_run()
    report = _build_demo_report(system, diagnostics, config.inject_at_frame)
    report["run_dir"] = str(result.run_dir)
    report_path = result.run_dir / "relocalization_demo_report.json"
    report_path.write_text(json.dumps(report, indent=2, sort_keys=True))
    report["report_path"] = str(report_path)
    return report


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Relocalization E2E demo")
    parser.add_argument("--dataset", type=Path, required=True)
    parser.add_argument("--sequence", default="00")
    parser.add_argument("--inject-at", type=int, default=10)
    parser.add_argument("--max-frames", type=int, default=30)
    parser.add_argument("--output-root", type=Path, default=Path("runs"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="torch device of every stage (cuda, cpu)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    report = run_relocalization_demo(
        RelocalizationDemoConfig(
            dataset_root=args.dataset,
            sequence=args.sequence,
            inject_at_frame=args.inject_at,
            max_frames=args.max_frames,
            output_root=args.output_root,
            seed=args.seed,
        ),
        device=args.device,
    )
    print(json.dumps({"recovered": report["recovered"], "report": report["report_path"]}))
    return 0 if report["recovered"] else 1


if __name__ == "__main__":
    sys.exit(main())
