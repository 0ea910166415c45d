"""KITTI run CLI: dataset validation → config → SLAMSystem → artifacts.

Port of ``mvslam_tpu/slam/runner.py``: ``run_kitti_sequence``, strict JSON
pipeline-config loading with unknown-field rejection, sync / streaming /
async / native ingestion selection (``async``: the ``runtime.ingestion``
decode pipeline, whose failure report is saved as ``ingestion_report``;
``native``: the C++ decode pool of ``mvslam_tpu_torch.native``, whose
counts and waits are saved under the same name, and which raises
``RuntimeError`` when the library cannot be built), artifact finalization.
``run_kitti_sequence(..., device="cuda")`` and ``--device`` carry the
device. Entry point: ``python -m mvslam_tpu_torch.slam.runner``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from mvslam_tpu_torch import native
from mvslam_tpu_torch.core.determinism import hash_config_path
from mvslam_tpu_torch.data.kitti import KittiSequence
from mvslam_tpu_torch.data.validation import validate_kitti
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
from mvslam_tpu_torch.backend.keyframes import KeyframeConfig
from mvslam_tpu_torch.runtime.frame_stream import FramePacket, _default_read_fn
from mvslam_tpu_torch.runtime.ingestion import AsyncIngestionPipeline, IngestionPipelineConfig
from mvslam_tpu_torch.slam.api import SLAMRunResult, SLAMSystem, SLAMSystemConfig

logger = logging.getLogger(__name__)


def _filter_strict(cls, payload: Dict[str, Any], section: str) -> Dict[str, Any]:
    """Reject unknown config fields (parity: ``slam_runner.py:34-39``)."""
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(payload) - known
    if unknown:
        raise ValueError(f"unknown {section} config fields: {sorted(unknown)}")
    return payload


def load_pipeline_config(path: Optional[Path]) -> Dict[str, Any]:
    """Load {feature, pose, keyframe} sections with strict field checking.

    Parity: ``slam_runner.py:42-71``.
    """
    if path is None:
        return {}
    payload = json.loads(Path(path).read_text())
    out: Dict[str, Any] = {}
    if "feature" in payload:
        out["feature"] = FeaturePipelineConfig(**_filter_strict(FeaturePipelineConfig, payload["feature"], "feature"))
    if "pose" in payload:
        out["pose"] = RobustPoseEstimatorConfig(**_filter_strict(RobustPoseEstimatorConfig, payload["pose"], "pose"))
    if "keyframe" in payload:
        out["keyframe"] = KeyframeConfig(**_filter_strict(KeyframeConfig, payload["keyframe"], "keyframe"))
    known_sections = {"feature", "pose", "keyframe", "run"}
    unknown = set(payload) - known_sections
    if unknown:
        raise ValueError(f"unknown pipeline config sections: {sorted(unknown)}")
    return out


def run_kitti_sequence(
    dataset_root: Path,
    sequence: str = "00",
    camera: int = 0,
    run_id: str = "kitti_run",
    output_root: Path = Path("runs"),
    seed: int = 0,
    max_frames: Optional[int] = None,
    config_path: Optional[Path] = None,
    ingestion: str = "stream",  # "sync" | "stream" | "async" | "native"
    buffer_size: int = 8,
    num_decode_workers: int = 2,
    validate: bool = True,
    inject_loss_at: Optional[int] = None,
    window: int = 8,
    windows_per_dispatch: int = 1,
    device="cuda",
) -> SLAMRunResult:
    """Validate the dataset, run the sequence on ``device``, persist the
    artifacts."""
    if ingestion not in ("sync", "stream", "async", "native"):
        raise ValueError(f"unknown ingestion mode {ingestion!r}")
    if ingestion == "native" and not native.native_available():
        raise RuntimeError("native ingestion requested but the C++ library is unavailable")
    if validate:
        result = validate_kitti(dataset_root, sequence, camera)
        if not result.ok:
            raise ValueError(f"dataset validation failed: {result.errors}")

    sections = load_pipeline_config(config_path)
    seq = KittiSequence(dataset_root, sequence, camera)
    K = seq.camera_intrinsics()
    config = SLAMSystemConfig(
        run_id=run_id,
        output_root=Path(output_root),
        seed=seed,
        config_hash=hash_config_path(config_path),
        fx=float(K[0, 0]),
        fy=float(K[1, 1]),
        cx=float(K[0, 2]),
        cy=float(K[1, 2]),
        **sections,
    )
    system = SLAMSystem(config, device=device)
    if inject_loss_at is not None:
        system.inject_tracking_loss(inject_loss_at)

    if ingestion == "sync":
        entries = seq.frame_entries(max_frames)
        frames: List = []
        timestamps: List[float] = []
        for e in entries:
            frame = _default_read_fn(e.path)
            if frame is not None:
                frames.append(np.asarray(frame))
                timestamps.append(e.timestamp)
        system.run_sequence(frames, timestamps, window=window, windows_per_dispatch=windows_per_dispatch)
    elif ingestion == "stream":
        system.run_stream(
            seq.iter_frames(max_frames, buffer_size=buffer_size),
            window=window,
            windows_per_dispatch=windows_per_dispatch,
        )
    elif ingestion == "native":
        entries = seq.frame_entries(max_frames)

        def native_packets():
            """The C++ decode pool's frames in order; a frame that failed to
            decode is skipped and counted in the report."""
            with native.NativeFrameLoader(
                [e.path for e in entries], workers=num_decode_workers, capacity=max(buffer_size, 2)
            ) as loader:
                for item in loader:
                    if item.frame is None:
                        continue
                    e = entries[item.index]
                    yield FramePacket(index=item.index, timestamp=e.timestamp, frame=item.frame, path=e.path)
                stats = loader.stats()
            system.store.save_report(
                "ingestion_report",
                {
                    "backend": "native",
                    "decoded": stats.decoded,
                    "failed": stats.failed,
                    "consumer_wait_s": stats.consumer_wait_s,
                    "worker_wait_s": stats.worker_wait_s,
                },
            )

        system.run_stream(native_packets(), window=window, windows_per_dispatch=windows_per_dispatch)
    else:
        entries = seq.frame_entries(max_frames)
        pipeline = AsyncIngestionPipeline(
            [e.path for e in entries],
            timestamps=[e.timestamp for e in entries],
            config=IngestionPipelineConfig(num_workers=num_decode_workers, queue_capacity=buffer_size),
        )
        system.run_stream(pipeline, window=window, windows_per_dispatch=windows_per_dispatch)
        system.store.save_report("ingestion_report", pipeline.failure_report().to_dict())
    return system.finalize_run()


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Run monocular SLAM on a KITTI sequence (PyTorch)")
    parser.add_argument("--dataset", type=Path, required=True)
    parser.add_argument("--sequence", default="00")
    parser.add_argument("--camera", type=int, default=0)
    parser.add_argument("--run-id", default="kitti_run")
    parser.add_argument("--output-root", type=Path, default=Path("runs"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--config", type=Path, default=None, help="pipeline config JSON")
    parser.add_argument("--ingestion", choices=["sync", "stream", "async", "native"], default="stream")
    parser.add_argument("--buffer-size", type=int, default=8)
    parser.add_argument("--decode-workers", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="torch device of every stage (cuda, cpu)")
    parser.add_argument("--window", type=int, default=8, help="frames per tracking call")
    parser.add_argument(
        "--windows-per-dispatch",
        type=int,
        default=1,
        help="windows run inside one dispatch (throughput mode)",
    )
    parser.add_argument("--no-validate", action="store_true")
    parser.add_argument("--inject-loss-at", type=int, default=None)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    result = run_kitti_sequence(
        dataset_root=args.dataset,
        sequence=args.sequence,
        camera=args.camera,
        run_id=args.run_id,
        output_root=args.output_root,
        seed=args.seed,
        max_frames=args.max_frames,
        config_path=args.config,
        ingestion=args.ingestion,
        buffer_size=args.buffer_size,
        num_decode_workers=args.decode_workers,
        validate=not args.no_validate,
        inject_loss_at=args.inject_loss_at,
        window=args.window,
        windows_per_dispatch=args.windows_per_dispatch,
        device=args.device,
    )
    print(
        json.dumps(
            {
                "run_dir": str(result.run_dir),
                "frames": result.num_frames,
                "keyframes": result.num_keyframes,
                "failures": result.num_failures,
                "relocalizations": result.num_relocalizations,
                "trajectory": str(result.trajectory_path),
            },
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
