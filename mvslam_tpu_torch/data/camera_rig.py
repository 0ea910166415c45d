"""Multi-camera rig modelling + calibration validation.

Parity: reference ``camera_rig.py`` — per-camera intrinsics/extrinsics from
KITTI ``P_rect_*`` / ``P*`` projections, stereo baseline computation, and a
calibration validation report (focal positivity, skew, normalisation,
conditioning, rotation orthonormality, baseline sanity — ref L137-285).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Mapping

import numpy as np


@dataclass(frozen=True)
class CameraIntrinsics:
    K: np.ndarray  # (3, 3)

    @property
    def fx(self) -> float:
        return float(self.K[0, 0])

    @property
    def fy(self) -> float:
        return float(self.K[1, 1])

    @property
    def principal_point(self) -> np.ndarray:
        return self.K[:2, 2].copy()


@dataclass(frozen=True)
class CameraExtrinsics:
    R: np.ndarray  # (3, 3) rotation rig→camera
    t: np.ndarray  # (3,) translation


@dataclass(frozen=True)
class CameraModel:
    name: str
    intrinsics: CameraIntrinsics
    extrinsics: CameraExtrinsics


@dataclass
class CalibrationIssue:
    camera: str
    severity: str  # "error" | "warning"
    message: str


@dataclass
class CalibrationReport:
    issues: List[CalibrationIssue] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not any(i.severity == "error" for i in self.issues)

    def to_dict(self) -> Dict:
        return {
            "ok": self.ok,
            "issues": [
                {"camera": i.camera, "severity": i.severity, "message": i.message}
                for i in self.issues
            ],
        }


class CameraRig:
    """Rig built from KITTI projection matrices.

    For rectified KITTI cameras, ``P_i = K [I | t_i]`` with
    ``t_i = (-baseline_i * fx, 0, 0)`` — the extrinsics fall out of the
    fourth column. Parity: ``camera_rig.py:95-135``.
    """

    def __init__(self, cameras: Mapping[str, CameraModel]) -> None:
        self.cameras = dict(cameras)

    @classmethod
    def from_kitti_calibration(cls, calib: Mapping[str, np.ndarray]) -> "CameraRig":
        cameras: Dict[str, CameraModel] = {}
        for key, values in calib.items():
            if not (key.startswith("P") and values.size == 12):
                continue
            P = np.asarray(values, dtype=np.float64).reshape(3, 4)
            K = P[:, :3]
            fx = K[0, 0]
            t = np.zeros(3) if abs(fx) < 1e-12 else np.linalg.solve(K, P[:, 3])
            cameras[key] = CameraModel(
                name=key,
                intrinsics=CameraIntrinsics(K=K.copy()),
                extrinsics=CameraExtrinsics(R=np.eye(3), t=t),
            )
        if not cameras:
            raise ValueError("no projection matrices found in calibration")
        return cls(cameras)

    def baseline(self, cam_a: str, cam_b: str) -> float:
        """Metric distance between two camera centres (parity: L130-135)."""
        ta = self.cameras[cam_a].extrinsics.t
        tb = self.cameras[cam_b].extrinsics.t
        return float(np.linalg.norm(ta - tb))

    def validate(self) -> CalibrationReport:
        """Parity: ``camera_rig.py:137-285``."""
        report = CalibrationReport()
        for name, cam in sorted(self.cameras.items()):
            K = cam.intrinsics.K
            if K[0, 0] <= 0 or K[1, 1] <= 0:
                report.issues.append(CalibrationIssue(name, "error", "non-positive focal length"))
            if abs(K[0, 1]) > 1e-3 * max(abs(K[0, 0]), 1.0):
                report.issues.append(CalibrationIssue(name, "warning", f"non-zero skew {K[0, 1]:.4g}"))
            if abs(K[2, 2] - 1.0) > 1e-6:
                report.issues.append(CalibrationIssue(name, "error", f"K[2,2]={K[2, 2]:.4g} != 1"))
            cond = float(np.linalg.cond(K))
            if cond > 1e6:
                report.issues.append(CalibrationIssue(name, "warning", f"ill-conditioned K (cond={cond:.3g})"))
            R = cam.extrinsics.R
            if np.abs(R @ R.T - np.eye(3)).max() > 1e-6 or abs(np.linalg.det(R) - 1.0) > 1e-6:
                report.issues.append(CalibrationIssue(name, "error", "extrinsic rotation not in SO(3)"))
        stereo_pairs = [("P0", "P1"), ("P2", "P3"), ("P_rect_00", "P_rect_01")]
        for a, b in stereo_pairs:
            if a in self.cameras and b in self.cameras:
                base = self.baseline(a, b)
                if base <= 0:
                    report.issues.append(CalibrationIssue(f"{a}/{b}", "error", "non-positive stereo baseline"))
        return report
