"""TUM RGB-D dataset loading (monocular rgb stream + ground truth).

Complements ``data.kitti``: the reference's second evaluation target is
TUM freiburg1 (``dataset_validation.py:293-332``, ``configs/evaluation/
tum_freiburg1.json``, ``tum_freiburg1_intrinsics.txt``). Layout::

    <root>/rgb/<timestamp>.png
    <root>/rgb.txt            # "timestamp filename" index (optional)
    <root>/groundtruth.txt    # "timestamp tx ty tz qx qy qz qw"
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

from mvslam_tpu_torch.runtime.frame_stream import FramePacket, FrameStream

# TUM freiburg1 default intrinsics (fx fy cx cy).
FREIBURG1_INTRINSICS = (517.3, 516.5, 318.6, 255.3)


def parse_rgb_index(path: Path) -> List[Tuple[float, str]]:
    """Parse ``rgb.txt`` (``timestamp filename`` lines, '#' comments)."""
    out: List[Tuple[float, str]] = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        out.append((float(parts[0]), parts[1]))
    return out


def load_groundtruth(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    """groundtruth.txt → (timestamps (N,), positions (N, 3))."""
    ts: List[float] = []
    pos: List[List[float]] = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(v) for v in line.split()]
        ts.append(vals[0])
        pos.append(vals[1:4])
    return np.asarray(ts), np.asarray(pos)


@dataclass(frozen=True)
class TumFrameEntry:
    index: int
    timestamp: float
    path: Path


class TumSequence:
    """One TUM RGB-D sequence (rgb stream only — monocular tracking)."""

    def __init__(self, root: Path) -> None:
        self.root = Path(root)
        rgb_dir = self.root / "rgb"
        if not rgb_dir.exists():
            raise FileNotFoundError(f"missing rgb/ under {self.root}")
        index_path = self.root / "rgb.txt"
        if index_path.exists():
            entries = parse_rgb_index(index_path)
            self.entries = [
                TumFrameEntry(index=i, timestamp=t, path=self.root / rel)
                for i, (t, rel) in enumerate(entries)
            ]
        else:
            paths = sorted(rgb_dir.glob("*.png")) + sorted(rgb_dir.glob("*.jpg"))

            def stamp(p: Path) -> float:
                try:
                    return float(p.stem)
                except ValueError:
                    return 0.0

            self.entries = [
                TumFrameEntry(index=i, timestamp=stamp(p), path=p) for i, p in enumerate(paths)
            ]

    def __len__(self) -> int:
        return len(self.entries)

    def camera_intrinsics(self, intrinsics_file: Optional[Path] = None) -> np.ndarray:
        if intrinsics_file is not None:
            from mvslam_tpu_torch.geometry.projection import load_K_from_file

            return load_K_from_file(intrinsics_file)
        fx, fy, cx, cy = FREIBURG1_INTRINSICS
        return np.asarray([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])

    def iter_frames(
        self, max_frames: Optional[int] = None, buffer_size: int = 8, recorder=None
    ) -> Iterator[FramePacket]:
        entries = self.entries[:max_frames] if max_frames else self.entries
        stream = FrameStream(
            [e.path for e in entries],
            timestamps=[e.timestamp for e in entries],
            buffer_size=buffer_size,
            recorder=recorder,
        )
        yield from stream

    def ground_truth(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        gt = self.root / "groundtruth.txt"
        return load_groundtruth(gt) if gt.exists() else None
