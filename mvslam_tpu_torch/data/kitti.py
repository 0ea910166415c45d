"""KITTI odometry dataset loading.

Parity: reference ``kitti_dataset.py`` — sequence path resolution, calib
parsing (``P0..P3`` 3x4 projection rows → K intrinsics), timestamp
parsing, ordered frame iteration, nearest-timestamp lookup.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

from mvslam_tpu_torch.runtime.frame_stream import FramePacket, FrameStream


def parse_kitti_calib_file(path: Path) -> Dict[str, np.ndarray]:
    """Parse ``key: v0 v1 ...`` calib lines into named float arrays.

    Parity: ``kitti_dataset.py:30-47``.
    """
    out: Dict[str, np.ndarray] = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or ":" not in line:
            continue
        key, _, rest = line.partition(":")
        try:
            values = np.asarray([float(v) for v in rest.split()], dtype=np.float64)
        except ValueError:
            continue
        out[key.strip()] = values
    return out


def projection_to_intrinsics(P: np.ndarray) -> np.ndarray:
    """3x4 KITTI projection → 3x3 K (parity: ``kitti_dataset.py:87-92``)."""
    P = np.asarray(P, dtype=np.float64).reshape(3, 4)
    return P[:, :3].copy()


def parse_timestamps(path: Path) -> List[float]:
    """times.txt: one float (seconds) per line. Parity: ``kitti_dataset.py:50-69``."""
    out: List[float] = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        out.append(float(line.split()[0]))
    return out


@dataclass(frozen=True)
class KittiFrameEntry:
    index: int
    timestamp: float
    path: Path


class KittiSequence:
    """One KITTI odometry sequence (``sequences/<seq>/image_<cam>``).

    Parity: ``kitti_dataset.py:111-217``.
    """

    def __init__(self, root: Path, sequence: str = "00", camera: int = 0) -> None:
        self.root = Path(root)
        self.sequence = sequence
        self.camera = camera
        self.seq_dir = self._resolve_sequence_dir()
        self.image_dir = self.seq_dir / f"image_{camera}"
        if not self.image_dir.exists():
            raise FileNotFoundError(f"missing image dir: {self.image_dir}")
        self.calib = parse_kitti_calib_file(self.seq_dir / "calib.txt") if (self.seq_dir / "calib.txt").exists() else {}
        times_path = self.seq_dir / "times.txt"
        self.timestamps = parse_timestamps(times_path) if times_path.exists() else []
        self.frame_paths = sorted(self.image_dir.glob("*.png")) + sorted(self.image_dir.glob("*.jpg"))
        if not self.timestamps:
            self.timestamps = [0.1 * i for i in range(len(self.frame_paths))]

    def _resolve_sequence_dir(self) -> Path:
        candidates = [
            self.root / "sequences" / self.sequence,
            self.root / self.sequence,
            self.root,
        ]
        for cand in candidates:
            if (cand / f"image_{self.camera}").exists():
                return cand
        raise FileNotFoundError(
            f"cannot resolve KITTI sequence {self.sequence!r} under {self.root}"
        )

    def __len__(self) -> int:
        return len(self.frame_paths)

    def camera_intrinsics(self) -> np.ndarray:
        key = f"P{self.camera}"
        if key in self.calib:
            return projection_to_intrinsics(self.calib[key])
        # KITTI odometry grayscale defaults (seq 00-02)
        return np.asarray(
            [[718.856, 0.0, 607.1928], [0.0, 718.856, 185.2157], [0.0, 0.0, 1.0]]
        )

    def frame_entries(self, max_frames: Optional[int] = None) -> List[KittiFrameEntry]:
        n = len(self.frame_paths) if max_frames is None else min(max_frames, len(self.frame_paths))
        return [
            KittiFrameEntry(index=i, timestamp=self.timestamps[i] if i < len(self.timestamps) else 0.1 * i, path=self.frame_paths[i])
            for i in range(n)
        ]

    def iter_frames(self, max_frames: Optional[int] = None, buffer_size: int = 8) -> Iterator[FramePacket]:
        """Stream frames via the background loader. Parity: ``kitti_dataset.py:194-200``."""
        entries = self.frame_entries(max_frames)
        stream = FrameStream(
            [e.path for e in entries],
            timestamps=[e.timestamp for e in entries],
            buffer_size=buffer_size,
        )
        yield from stream

    def nearest_frame(self, timestamp: float) -> int:
        """Nearest-timestamp bisect (parity: ``kitti_dataset.py:478-491``)."""
        idx = bisect.bisect_left(self.timestamps, timestamp)
        if idx <= 0:
            return 0
        if idx >= len(self.timestamps):
            return len(self.timestamps) - 1
        before = self.timestamps[idx - 1]
        after = self.timestamps[idx]
        return idx if (after - timestamp) < (timestamp - before) else idx - 1


@dataclass
class SyncReport:
    """Parity: ``kitti_dataset.py:262-431`` sync report."""

    matched: int = 0
    dropped_primary: int = 0
    dropped_secondary: int = 0
    max_time_offset_s: float = 0.0
    method: str = "timestamp"

    def to_dict(self) -> Dict[str, float]:
        return {
            "matched": self.matched,
            "dropped_primary": self.dropped_primary,
            "dropped_secondary": self.dropped_secondary,
            "max_time_offset_s": self.max_time_offset_s,
            "method": self.method,
        }


class MultiCameraKittiSequence:
    """Synchronised multi-camera access over one KITTI sequence.

    Parity: ``kitti_dataset.py:262-431`` — timestamp matching with a
    tolerance (or index matching as fallback) across cameras, emitting a
    sync report; plus rig calibration via :class:`data.camera_rig.CameraRig`.
    """

    def __init__(self, root: Path, sequence: str = "00", cameras: tuple = (0, 1)) -> None:
        self.sequences = {cam: KittiSequence(root, sequence, cam) for cam in cameras}
        self.cameras = tuple(cameras)

    def rig(self):
        from mvslam_tpu_torch.data.camera_rig import CameraRig

        primary = self.sequences[self.cameras[0]]
        return CameraRig.from_kitti_calibration(primary.calib)

    def synchronize(
        self, tolerance_s: float = 0.01, method: str = "timestamp"
    ) -> tuple:
        """Returns (list of {camera: frame_index} dicts, SyncReport)."""
        primary_cam = self.cameras[0]
        primary = self.sequences[primary_cam]
        report = SyncReport(method=method)
        matched: List[Dict[int, int]] = []
        if method == "index":
            n = min(len(self.sequences[c]) for c in self.cameras)
            for i in range(n):
                matched.append({c: i for c in self.cameras})
            report.matched = n
            report.dropped_primary = len(primary) - n
            return matched, report
        for i, ts in enumerate(primary.timestamps[: len(primary)]):
            entry = {primary_cam: i}
            ok = True
            worst = 0.0
            for cam in self.cameras[1:]:
                seq = self.sequences[cam]
                j = seq.nearest_frame(ts)
                offset = abs(seq.timestamps[j] - ts) if j < len(seq.timestamps) else float("inf")
                if offset > tolerance_s:
                    ok = False
                    break
                worst = max(worst, offset)
                entry[cam] = j
            if ok:
                matched.append(entry)
                report.matched += 1
                report.max_time_offset_s = max(report.max_time_offset_s, worst)
            else:
                report.dropped_primary += 1
        for cam in self.cameras[1:]:
            used = {m[cam] for m in matched}
            report.dropped_secondary += len(self.sequences[cam]) - len(used)
        return matched, report


def _normalize_drive_id(drive: str) -> str:
    """Zero-pad numeric drive ids to 4 digits (parity: ref offline entry L281-283)."""
    drive_str = str(drive)
    return drive_str.zfill(4) if drive_str.isdigit() else drive_str


def load_oxts_positions(oxts_dir: Path) -> np.ndarray:
    """Parse a KITTI-raw ``oxts/data`` directory into local metric positions.

    Each per-frame ``*.txt`` starts with ``lat lon alt ...``; positions are
    projected to a local east/north/up frame anchored at the first fix via
    the equirectangular approximation (x = east, y = north, z = alt delta).
    Parity: ``visual_slam_offline_entry_point.py:295-324``
    (``load_kitti_oxts_positions``).
    """
    oxts_dir = Path(oxts_dir)
    if not oxts_dir.exists():
        raise FileNotFoundError(f"missing oxts directory: {oxts_dir}")
    files = sorted(oxts_dir.glob("*.txt"))
    if not files:
        raise FileNotFoundError(f"no oxts files in {oxts_dir}")
    fixes = []
    for path in files:
        line = path.read_text().strip().splitlines()
        if not line:
            continue
        parts = line[0].split()
        fixes.append((float(parts[0]), float(parts[1]), float(parts[2])))
    if not fixes:
        raise ValueError(f"no valid OXTS entries under {oxts_dir}")
    geo = np.asarray(fixes, dtype=np.float64)  # (N, 3) lat/lon/alt
    lat0, lon0, alt0 = geo[0]
    earth_radius = 6378137.0
    east = np.radians(geo[:, 1] - lon0) * earth_radius * np.cos(np.radians(lat0))
    north = np.radians(geo[:, 0] - lat0) * earth_radius
    up = geo[:, 2] - alt0
    return np.stack([east, north, up], axis=1)


@dataclass(frozen=True)
class KittiRawSession:
    """KITTI-raw drive layout ``<base>/<date>/<date>_drive_<drive>_sync``.

    Provides image paths, ``P_rect_*`` intrinsics from
    ``calib_cam_to_cam.txt``, and OXTS ground-truth positions. Parity:
    ``visual_slam_offline_entry_point.py:253-341`` (``KittiRawSession``,
    ``load_kitti_image_paths``, ``load_kitti_oxts_positions``,
    ``load_kitti_intrinsics``).
    """

    base_dir: Path
    date: str
    drive: str
    camera: str = "image_00"

    @property
    def date_dir(self) -> Path:
        return Path(self.base_dir) / self.date

    @property
    def drive_dir(self) -> Path:
        return self.date_dir / f"{self.date}_drive_{_normalize_drive_id(self.drive)}_sync"

    @property
    def image_dir(self) -> Path:
        return self.drive_dir / self.camera / "data"

    @property
    def oxts_dir(self) -> Path:
        return self.drive_dir / "oxts" / "data"

    @property
    def calib_cam_to_cam(self) -> Path:
        return self.date_dir / "calib_cam_to_cam.txt"

    def image_paths(self) -> List[Path]:
        if not self.image_dir.exists():
            raise FileNotFoundError(f"missing image dir: {self.image_dir}")
        paths = sorted(self.image_dir.glob("*.png"))
        if not paths:
            raise FileNotFoundError(f"no images in {self.image_dir}")
        return paths

    def camera_intrinsics(self) -> np.ndarray:
        """K from the drive date's ``P_rect_<cam>`` rectified projection."""
        if not self.calib_cam_to_cam.exists():
            raise FileNotFoundError(f"missing calibration: {self.calib_cam_to_cam}")
        calib = parse_kitti_calib_file(self.calib_cam_to_cam)
        cam_idx = self.camera.split("_")[-1]
        key = f"P_rect_{cam_idx}"
        if key not in calib:
            raise KeyError(f"{key} not found in {self.calib_cam_to_cam}")
        return projection_to_intrinsics(calib[key])

    def oxts_positions(self) -> np.ndarray:
        """(N, 3) east/north/up metric ground-truth positions."""
        return load_oxts_positions(self.oxts_dir)

    def iter_frames(
        self, max_frames: Optional[int] = None, buffer_size: int = 8
    ) -> Iterator[FramePacket]:
        paths = self.image_paths()
        if max_frames is not None:
            paths = paths[:max_frames]
        stream = FrameStream(
            paths, timestamps=[0.1 * i for i in range(len(paths))], buffer_size=buffer_size
        )
        yield from stream


def load_ground_truth_poses(path: Path) -> np.ndarray:
    """KITTI odometry poses file: each line 12 floats (3x4 row-major) → (N, 4, 4)."""
    rows = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        vals = np.asarray([float(v) for v in line.split()], dtype=np.float64)
        T = np.eye(4)
        T[:3, :] = vals.reshape(3, 4)
        rows.append(T)
    return np.stack(rows) if rows else np.zeros((0, 4, 4))
