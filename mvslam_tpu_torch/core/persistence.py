"""Run artifact store, streaming summaries, and the P² quantile estimator.

Counterpart of the reference's ``data_persistence.py`` (RunDataStore
L207-554, P2Quantile L80-165, streaming JSON iteration L704-763). Every
artifact embeds the determinism payload ``{seed, config_hash}`` so the
bit-reproducibility auditor can compare runs.

Layout under each run directory::

    trajectories/   <name>.npz        poses (N,4,4) f64 + timestamps + frame_ids
    metrics/        <name>.json
    diagnostics/    <name>.json       (JSON array of per-frame records)
    telemetry/      <name>.json       (JSON array of TelemetryEvent dicts)
    maps/           <name>_arrays.npz + <name>_metadata.json
    reports/        <name>.json       (control-plane / readiness reports)

Copied close to verbatim from ``mvslam_tpu/core/persistence.py``: it needs numpy only.
"""

from __future__ import annotations

import json
import re
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np

_SAFE_NAME = re.compile(r"[^A-Za-z0-9._-]+")


def sanitize_artifact_name(name: str) -> str:
    """Parity: ``data_persistence.py:561-567``."""
    cleaned = _SAFE_NAME.sub("_", name.strip()) or "artifact"
    return cleaned[:128]


# ---------------------------------------------------------------------------
# P² streaming quantile estimator
# ---------------------------------------------------------------------------


class P2Quantile:
    """Jain & Chlamtac P² streaming quantile estimator, O(1) memory.

    Parity: ``data_persistence.py:80-165``. Used by every metric tracker in
    the control planes so health snapshots never hold full histories.
    """

    def __init__(self, quantile: float) -> None:
        if not 0.0 < quantile < 1.0:
            raise ValueError(f"quantile must be in (0,1), got {quantile}")
        self.quantile = quantile
        self._initial: List[float] = []
        self._count = 0
        # marker heights q, positions n, desired positions np_, increments dn
        self._q: List[float] = []
        self._n: List[float] = []
        self._np: List[float] = []
        self._dn: List[float] = []

    @property
    def count(self) -> int:
        return self._count

    def update(self, value: float) -> None:
        value = float(value)
        self._count += 1
        if len(self._initial) < 5 and not self._q:
            self._initial.append(value)
            if len(self._initial) == 5:
                self._initial.sort()
                p = self.quantile
                self._q = list(self._initial)
                self._n = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._np = [1.0, 1.0 + 2.0 * p, 1.0 + 4.0 * p, 3.0 + 2.0 * p, 5.0]
                self._dn = [0.0, p / 2.0, p, (1.0 + p) / 2.0, 1.0]
            return

        q, n = self._q, self._n
        if value < q[0]:
            q[0] = value
            k = 0
        elif value >= q[4]:
            q[4] = value
            k = 3
        else:
            k = 0
            for i in range(1, 4):
                if value < q[i]:
                    k = i - 1
                    break
            else:
                k = 3
        for i in range(k + 1, 5):
            n[i] += 1.0
        for i in range(5):
            self._np[i] += self._dn[i]

        for i in range(1, 4):
            d = self._np[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) or (d <= -1.0 and n[i - 1] - n[i] < -1.0):
                step = 1.0 if d >= 0 else -1.0
                candidate = self._parabolic(i, step)
                if q[i - 1] < candidate < q[i + 1]:
                    q[i] = candidate
                else:
                    q[i] = self._linear(i, step)
                n[i] += step

    def _parabolic(self, i: int, d: float) -> float:
        q, n = self._q, self._n
        return q[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (q[i + 1] - q[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (q[i] - q[i - 1]) / (n[i] - n[i - 1])
        )

    def _linear(self, i: int, d: float) -> float:
        q, n = self._q, self._n
        j = i + int(d)
        return q[i] + d * (q[j] - q[i]) / (n[j] - n[i])

    def value(self) -> float:
        if self._q:
            return self._q[2]
        if not self._initial:
            return float("nan")
        data = sorted(self._initial)
        idx = self.quantile * (len(data) - 1)
        lo = int(idx)
        hi = min(lo + 1, len(data) - 1)
        frac = idx - lo
        return data[lo] * (1.0 - frac) + data[hi] * frac


class StreamingMoments:
    """Welford mean/variance tracker paired with P² quantiles."""

    def __init__(self, quantiles: Sequence[float] = (0.5, 0.95, 0.99)) -> None:
        self.count = 0
        self._mean = 0.0
        self._m2 = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._quantiles = {q: P2Quantile(q) for q in quantiles}

    def update(self, value: float) -> None:
        value = float(value)
        self.count += 1
        delta = value - self._mean
        self._mean += delta / self.count
        self._m2 += delta * (value - self._mean)
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        for est in self._quantiles.values():
            est.update(value)

    @property
    def mean(self) -> float:
        return self._mean if self.count else float("nan")

    @property
    def std(self) -> float:
        if self.count < 2:
            return 0.0
        return (self._m2 / (self.count - 1)) ** 0.5

    def summary(self) -> Dict[str, float]:
        out = {
            "count": self.count,
            "mean": self.mean,
            "std": self.std,
            "min": self.min if self.count else float("nan"),
            "max": self.max if self.count else float("nan"),
        }
        for q, est in self._quantiles.items():
            out[f"p{int(round(q * 100))}"] = est.value()
        return out


# ---------------------------------------------------------------------------
# Streaming JSON array iteration
# ---------------------------------------------------------------------------


def iter_json_array_items(path: Path, chunk_size: int = 1 << 16) -> Iterator[Any]:
    """Yield items of a JSON array file without loading it whole.

    Parity: ``data_persistence.py:704-763`` (chunked ``raw_decode``). Keeps
    memory O(item) for arbitrarily long telemetry / diagnostics logs.
    """
    decoder = json.JSONDecoder()
    buf = ""
    started = False
    with open(path, "r", encoding="utf-8") as fh:
        while True:
            chunk = fh.read(chunk_size)
            if chunk:
                buf += chunk
            pos = 0
            n = len(buf)
            while True:
                while pos < n and buf[pos] in " \t\r\n,":
                    pos += 1
                if pos >= n:
                    break
                ch = buf[pos]
                if not started:
                    if ch != "[":
                        raise ValueError(f"{path}: expected JSON array, got {ch!r}")
                    started = True
                    pos += 1
                    continue
                if ch == "]":
                    return
                try:
                    item, end = decoder.raw_decode(buf, pos)
                except json.JSONDecodeError:
                    break  # need more data
                yield item
                pos = end
            buf = buf[pos:]
            if not chunk:
                if buf.strip(" \t\r\n,]"):
                    raise ValueError(f"{path}: truncated JSON array")
                return


# ---------------------------------------------------------------------------
# Trajectory accumulation + summaries
# ---------------------------------------------------------------------------


@dataclass
class TrajectoryAccumulator:
    """Collects (frame_id, timestamp, 4x4 pose) triples during a run.

    Parity: ``data_persistence.py:177-204``.
    """

    poses: List[np.ndarray] = field(default_factory=list)
    timestamps: List[float] = field(default_factory=list)
    frame_ids: List[int] = field(default_factory=list)

    def append(self, frame_id: int, timestamp: float, pose: np.ndarray) -> None:
        pose = np.asarray(pose, dtype=np.float64)
        if pose.shape != (4, 4):
            raise ValueError(f"pose must be (4,4), got {pose.shape}")
        self.poses.append(pose)
        self.timestamps.append(float(timestamp))
        self.frame_ids.append(int(frame_id))

    def __len__(self) -> int:
        return len(self.poses)

    def as_arrays(self) -> Dict[str, np.ndarray]:
        n = len(self.poses)
        return {
            "poses": np.stack(self.poses) if n else np.zeros((0, 4, 4)),
            "timestamps": np.asarray(self.timestamps, dtype=np.float64),
            "frame_ids": np.asarray(self.frame_ids, dtype=np.int64),
        }


def summarize_trajectory(poses: np.ndarray) -> Dict[str, float]:
    """num_poses / total_distance / mean + max step length.

    Parity: ``data_persistence.py:614-626``.
    """
    poses = np.asarray(poses)
    n = int(poses.shape[0])
    if n < 2:
        return {"num_poses": n, "total_distance": 0.0, "mean_step": 0.0, "max_step": 0.0}
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return {
        "num_poses": n,
        "total_distance": float(steps.sum()),
        "mean_step": float(steps.mean()),
        "max_step": float(steps.max()),
    }


def summarize_frame_diagnostics_streaming(path: Path) -> Dict[str, Any]:
    """Stream per-frame diagnostics JSON into aggregate statistics.

    Parity: ``data_persistence.py:766-820``.
    """
    stats: Dict[str, StreamingMoments] = {}
    frames = 0
    failures = 0
    keyframes = 0
    relocalizations = 0
    for item in iter_json_array_items(Path(path)):
        frames += 1
        if not item.get("pose_success", True):
            failures += 1
        if item.get("is_keyframe"):
            keyframes += 1
        if item.get("relocalized"):
            relocalizations += 1
        for key in ("num_features", "num_matches", "num_inliers", "inlier_ratio", "parallax"):
            value = item.get(key)
            if value is None:
                continue
            stats.setdefault(key, StreamingMoments()).update(float(value))
    return {
        "frames": frames,
        "pose_failures": failures,
        "keyframes": keyframes,
        "relocalizations": relocalizations,
        "metrics": {k: v.summary() for k, v in sorted(stats.items())},
    }


# ---------------------------------------------------------------------------
# RunDataStore
# ---------------------------------------------------------------------------

_SUBDIRS = ("trajectories", "metrics", "diagnostics", "telemetry", "maps", "reports")


class RunDataStore:
    """Per-run artifact store with determinism payloads in every artifact.

    Parity: ``data_persistence.py:207-554``.
    """

    def __init__(self, run_dir: Path, determinism: Optional[Mapping[str, Any]] = None) -> None:
        self.run_dir = Path(run_dir)
        self.determinism = dict(determinism or {})
        self._lock = threading.Lock()
        for sub in _SUBDIRS:
            (self.run_dir / sub).mkdir(parents=True, exist_ok=True)

    # -- trajectories -------------------------------------------------------

    def save_trajectory(self, name: str, accumulator: TrajectoryAccumulator) -> Path:
        arrays = accumulator.as_arrays()
        path = self.run_dir / "trajectories" / f"{sanitize_artifact_name(name)}.npz"
        with self._lock:
            np.savez(
                path,
                poses=arrays["poses"],
                timestamps=arrays["timestamps"],
                frame_ids=arrays["frame_ids"],
                determinism=json.dumps(self.determinism, sort_keys=True),
            )
        return path

    def load_trajectory(self, name: str) -> Dict[str, Any]:
        path = self.run_dir / "trajectories" / f"{sanitize_artifact_name(name)}.npz"
        with np.load(path, allow_pickle=False) as data:
            out = {
                "poses": np.asarray(data["poses"]),
                "timestamps": np.asarray(data["timestamps"]),
                "frame_ids": np.asarray(data["frame_ids"]),
                "determinism": json.loads(str(data["determinism"])),
            }
        return out

    # -- json artifact families ---------------------------------------------

    def _save_json(self, sub: str, name: str, payload: Any) -> Path:
        path = self.run_dir / sub / f"{sanitize_artifact_name(name)}.json"
        with self._lock:
            path.write_text(json.dumps(payload, indent=2, sort_keys=isinstance(payload, dict), default=str))
        return path

    def _load_json(self, sub: str, name: str) -> Any:
        path = self.run_dir / sub / f"{sanitize_artifact_name(name)}.json"
        return json.loads(path.read_text())

    def save_metrics(self, name: str, metrics: Mapping[str, Any]) -> Path:
        return self._save_json("metrics", name, {"metrics": dict(metrics), "determinism": self.determinism})

    def load_metrics(self, name: str) -> Dict[str, Any]:
        return self._load_json("metrics", name)

    def save_frame_diagnostics(self, name: str, records: Sequence[Mapping[str, Any]]) -> Path:
        return self._save_json("diagnostics", name, [dict(r) for r in records])

    def diagnostics_path(self, name: str) -> Path:
        return self.run_dir / "diagnostics" / f"{sanitize_artifact_name(name)}.json"

    def save_telemetry(self, name: str, events: Sequence[Any]) -> Path:
        payload = [e.to_dict() if hasattr(e, "to_dict") else dict(e) for e in events]
        return self._save_json("telemetry", name, payload)

    def telemetry_path(self, name: str) -> Path:
        return self.run_dir / "telemetry" / f"{sanitize_artifact_name(name)}.json"

    def save_report(self, name: str, report: Mapping[str, Any]) -> Path:
        return self._save_json("reports", name, dict(report))

    def load_report(self, name: str) -> Dict[str, Any]:
        return self._load_json("reports", name)

    # -- maps ----------------------------------------------------------------

    def map_paths(self, name: str) -> Dict[str, Path]:
        base = sanitize_artifact_name(name)
        return {
            "arrays": self.run_dir / "maps" / f"{base}_arrays.npz",
            "metadata": self.run_dir / "maps" / f"{base}_metadata.json",
        }

    # -- loaders + bundle validation ------------------------------------------

    def load_frame_diagnostics(self, name: str) -> List[Dict[str, Any]]:
        return self._load_json("diagnostics", name)

    def load_telemetry(self, name: str) -> List[Dict[str, Any]]:
        return self._load_json("telemetry", name)

    def validate_bundle(self) -> Dict[str, Any]:
        """Structural validation of the run bundle: required artifacts
        present, loadable, and all determinism payloads consistent.

        Parity: the reference's bundle + validation surface
        (``data_persistence.py`` bundles).
        """
        issues: List[str] = []
        seen_determinism: List[Dict[str, Any]] = []
        traj_dir = self.run_dir / "trajectories"
        trajectories = sorted(traj_dir.glob("*.npz")) if traj_dir.exists() else []
        if not trajectories:
            issues.append("no trajectory artifacts")
        for path in trajectories:
            try:
                loaded = self.load_trajectory(path.stem)
                if loaded["poses"].ndim != 3 or loaded["poses"].shape[1:] != (4, 4):
                    issues.append(f"{path.name}: poses shape {loaded['poses'].shape}")
                if len(loaded["timestamps"]) != len(loaded["poses"]):
                    issues.append(f"{path.name}: timestamp/pose length mismatch")
                seen_determinism.append(loaded["determinism"])
            except Exception as exc:
                issues.append(f"{path.name}: unreadable ({exc})")
        for sub in ("metrics", "diagnostics", "telemetry", "reports"):
            folder = self.run_dir / sub
            for path in sorted(folder.glob("*.json")) if folder.exists() else []:
                try:
                    payload = json.loads(path.read_text())
                except json.JSONDecodeError as exc:
                    issues.append(f"{sub}/{path.name}: invalid JSON ({exc})")
                    continue
                if isinstance(payload, dict) and "determinism" in payload:
                    seen_determinism.append(payload["determinism"])
        if len({json.dumps(d, sort_keys=True) for d in seen_determinism}) > 1:
            issues.append("inconsistent determinism payloads across artifacts")
        return {"ok": not issues, "issues": issues, "artifacts": self.list_artifacts()}

    # -- discovery ------------------------------------------------------------

    def list_artifacts(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {}
        for sub in _SUBDIRS:
            folder = self.run_dir / sub
            out[sub] = sorted(p.name for p in folder.iterdir()) if folder.exists() else []
        return out
