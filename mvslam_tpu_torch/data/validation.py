"""Dataset validation CLI + API (KITTI odometry, TUM layouts).

Parity: reference ``dataset_validation.py`` — structural checks (layout,
images, timestamps, calibration), JSON output, ``--strict`` exit codes.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mvslam_tpu_torch.data.camera_rig import CameraRig
from mvslam_tpu_torch.data.kitti import parse_kitti_calib_file, parse_timestamps


@dataclass
class ValidationResult:
    dataset: str
    ok: bool
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    stats: Dict = field(default_factory=dict)

    def to_dict(self) -> Dict:
        return {
            "dataset": self.dataset,
            "ok": self.ok,
            "errors": self.errors,
            "warnings": self.warnings,
            "stats": self.stats,
        }


def validate_kitti(root: Path, sequence: str = "00", camera: int = 0) -> ValidationResult:
    """Layout/images/timestamps/calib checks. Parity: ``dataset_validation.py:92-185``."""
    result = ValidationResult(dataset=f"kitti:{sequence}", ok=True)
    root = Path(root)
    seq_dirs = [root / "sequences" / sequence, root / sequence, root]
    seq_dir = next((d for d in seq_dirs if (d / f"image_{camera}").exists()), None)
    if seq_dir is None:
        result.ok = False
        result.errors.append(f"no image_{camera} directory under {root}")
        return result
    image_dir = seq_dir / f"image_{camera}"
    images = sorted(image_dir.glob("*.png")) + sorted(image_dir.glob("*.jpg"))
    result.stats["num_images"] = len(images)
    if not images:
        result.ok = False
        result.errors.append(f"no images in {image_dir}")

    times_path = seq_dir / "times.txt"
    if times_path.exists():
        try:
            times = parse_timestamps(times_path)
            result.stats["num_timestamps"] = len(times)
            if len(times) < len(images):
                result.ok = False
                result.errors.append(
                    f"times.txt has {len(times)} entries for {len(images)} images"
                )
            diffs = np.diff(times)
            if len(diffs) and (diffs <= 0).any():
                result.warnings.append("non-monotonic timestamps")
        except ValueError as exc:
            result.ok = False
            result.errors.append(f"unparseable times.txt: {exc}")
    else:
        result.warnings.append("missing times.txt (synthetic timestamps will be used)")

    calib_path = seq_dir / "calib.txt"
    if calib_path.exists():
        calib = parse_kitti_calib_file(calib_path)
        if f"P{camera}" not in calib:
            result.warnings.append(f"calib.txt missing P{camera} (defaults will be used)")
        else:
            try:
                rig = CameraRig.from_kitti_calibration(calib)
                report = rig.validate()
                result.stats["calibration"] = report.to_dict()
                if not report.ok:
                    result.ok = False
                    result.errors.extend(
                        f"calibration: {i.message}" for i in report.issues if i.severity == "error"
                    )
            except ValueError as exc:
                result.ok = False
                result.errors.append(f"calibration: {exc}")
    else:
        result.warnings.append("missing calib.txt (defaults will be used)")
    return result


def validate_kitti_multi_camera(
    root: Path,
    sequence: str = "00",
    cameras: tuple = (0, 1),
    sync_tolerance_s: float = 0.002,
) -> ValidationResult:
    """Multi-camera layout + calibration + cross-camera sync validation.

    Parity: ``dataset_validation.py:188-290`` — per-camera image checks,
    rig calibration validation (baselines, SO(3), intrinsics), and a
    timestamp synchronization dry run whose report (matched/dropped
    counts, worst offset) lands in ``stats["sync_report"]``.
    """
    cameras = tuple(int(c) for c in cameras)
    result = ValidationResult(
        dataset=f"kitti_multi:{sequence}:{','.join(map(str, cameras))}", ok=True
    )
    root = Path(root)
    if not root.exists():
        result.ok = False
        result.errors.append(f"KITTI root does not exist: {root}")
        return result
    seq_dirs = [root / "sequences" / sequence, root / sequence, root]
    seq_dir = next(
        (d for d in seq_dirs if any((d / f"image_{c}").exists() for c in cameras)), None
    )
    if seq_dir is None:
        result.ok = False
        result.errors.append(f"sequence '{sequence}' not found under {root}")
        return result
    result.stats["sequence_path"] = str(seq_dir)
    result.stats["cameras"] = list(cameras)
    result.stats["sync_tolerance_s"] = sync_tolerance_s

    for camera in cameras:
        image_dir = seq_dir / f"image_{camera}"
        if not image_dir.exists():
            result.ok = False
            result.errors.append(f"no image_{camera} directory in {seq_dir}")
            continue
        images = sorted(image_dir.glob("*.png")) + sorted(image_dir.glob("*.jpg"))
        result.stats[f"camera_{camera}_num_images"] = len(images)
        if not images:
            result.ok = False
            result.errors.append(f"no images in {image_dir}")

    calib_path = seq_dir / "calib.txt"
    if not calib_path.exists():
        result.warnings.append("missing calib.txt (rig validation skipped)")
    else:
        calib = parse_kitti_calib_file(calib_path)
        missing = [c for c in cameras if f"P{c}" not in calib]
        if missing:
            result.ok = False
            result.errors.extend(f"calib.txt missing P{c}" for c in missing)
        else:
            try:
                rig = CameraRig.from_kitti_calibration(calib)
                report = rig.validate()
                result.stats["calibration"] = report.to_dict()
                if not report.ok:
                    result.ok = False
                    result.errors.extend(
                        f"calibration: {i.message}"
                        for i in report.issues
                        if i.severity == "error"
                    )
            except ValueError as exc:
                result.ok = False
                result.errors.append(f"calibration: {exc}")

    if result.ok:
        try:
            from mvslam_tpu_torch.data.kitti import MultiCameraKittiSequence

            multi = MultiCameraKittiSequence(root, sequence, cameras=cameras)
            matched, sync_report = multi.synchronize(tolerance_s=sync_tolerance_s)
            result.stats["sync_report"] = sync_report.to_dict()
            if not matched:
                result.ok = False
                result.errors.append("no synchronized frame tuples across cameras")
            elif sync_report.dropped_primary:
                result.warnings.append(
                    f"{sync_report.dropped_primary} primary frames had no partner "
                    f"within {sync_tolerance_s}s"
                )
        except Exception as exc:
            result.ok = False
            result.errors.append(f"multi-camera sync failed: {exc}")
    return result


def validate_tum(root: Path) -> ValidationResult:
    """TUM RGB-D layout: rgb/ + groundtruth.txt. Parity: ``dataset_validation.py:293-332``."""
    result = ValidationResult(dataset="tum", ok=True)
    root = Path(root)
    rgb = root / "rgb"
    if not rgb.exists():
        result.ok = False
        result.errors.append(f"missing rgb/ under {root}")
    else:
        images = sorted(rgb.glob("*.png")) + sorted(rgb.glob("*.jpg"))
        result.stats["num_images"] = len(images)
        if not images:
            result.ok = False
            result.errors.append("rgb/ contains no images")
    gt = root / "groundtruth.txt"
    if not gt.exists():
        result.warnings.append("missing groundtruth.txt (evaluation unavailable)")
    return result


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Validate SLAM dataset layouts")
    parser.add_argument("root", type=Path)
    parser.add_argument(
        "--format", choices=["kitti", "kitti_multi", "tum"], default="kitti"
    )
    parser.add_argument("--sequence", default="00")
    parser.add_argument("--camera", type=int, default=0)
    parser.add_argument(
        "--cameras",
        default="0,1",
        help="comma-separated camera ids for --format kitti_multi",
    )
    parser.add_argument(
        "--sync-tolerance-s", type=float, default=0.002,
        help="cross-camera timestamp tolerance for --format kitti_multi",
    )
    parser.add_argument("--json", action="store_true", help="emit JSON report")
    parser.add_argument("--strict", action="store_true", help="exit 1 on warnings too")
    args = parser.parse_args(argv)
    if args.format == "kitti":
        result = validate_kitti(args.root, args.sequence, args.camera)
    elif args.format == "kitti_multi":
        cameras = tuple(int(c) for c in args.cameras.split(",") if c != "")
        result = validate_kitti_multi_camera(
            args.root, args.sequence, cameras, args.sync_tolerance_s
        )
    else:
        result = validate_tum(args.root)
    if args.json:
        print(json.dumps(result.to_dict(), indent=2))
    else:
        print(f"dataset={result.dataset} ok={result.ok}")
        for err in result.errors:
            print(f"  ERROR: {err}")
        for warn in result.warnings:
            print(f"  WARN:  {warn}")
    if not result.ok:
        return 1
    if args.strict and result.warnings:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
