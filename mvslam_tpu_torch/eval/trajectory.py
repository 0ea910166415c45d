"""Trajectory metrics: ATE / RPE with Umeyama alignment + CLI.

Parity: reference ``evaluate_trajectory.py`` — trajectory txt loading with
per-format column selection (``kitti_odom`` → columns [3, 7, 11] of the
3x4 row-major pose lines), similarity alignment with det-flip guard (ref
L34-53), ``compute_ate`` (RMSE after alignment, ref L56-65),
``compute_rpe`` (ref L68-78), ``compute_additional_metrics`` → ATE/RPE
{RMSE, MEAN, MEDIAN} (ref L81-116), and txt/json/csv report writers.

Alignment runs on host in float64 (gate tolerances are percent-level).

Copied close to verbatim from ``mvslam_tpu/eval/trajectory.py``: it needs numpy only.
"""

from __future__ import annotations

import argparse
import csv
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np


FORMAT_COLUMNS = {
    "xyz": (0, 1, 2),
    "tum": (1, 2, 3),  # timestamp x y z qx qy qz qw
    "kitti_odom": (3, 7, 11),  # 3x4 row-major pose
}


def load_trajectory_file(path: Path, fmt: str = "kitti_odom") -> np.ndarray:
    """(N, 3) positions from a text trajectory. Parity: ``evaluate_trajectory.py:152-157``."""
    cols = FORMAT_COLUMNS.get(fmt)
    if cols is None:
        raise ValueError(f"unknown trajectory format {fmt!r}; known: {sorted(FORMAT_COLUMNS)}")
    rows: List[List[float]] = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        vals = [float(v) for v in line.split()]
        rows.append([vals[c] for c in cols])
    return np.asarray(rows, dtype=np.float64)


def positions_from_poses(poses: np.ndarray) -> np.ndarray:
    """(N, 4, 4) → (N, 3)."""
    return np.asarray(poses)[:, :3, 3]


def align_trajectories(est: np.ndarray, gt: np.ndarray, with_scale: bool = True) -> np.ndarray:
    """Umeyama-align est → gt (monocular evaluation needs scale).

    Runs in float64 on host: gate tolerances are percent-level.
    """
    n = min(len(est), len(gt))
    est = np.asarray(est[:n], dtype=np.float64)
    gt = np.asarray(gt[:n], dtype=np.float64)
    mu_s = est.mean(axis=0)
    mu_t = gt.mean(axis=0)
    src_c = est - mu_s
    tgt_c = gt - mu_t
    cov = tgt_c.T @ src_c / n
    U, D, Vt = np.linalg.svd(cov)
    d = est.shape[1]
    S = np.ones(d)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[-1] = -1.0
    R = (U * S[None, :]) @ Vt
    var_s = np.mean(np.sum(src_c * src_c, axis=1))
    scale = float(np.sum(D * S) / max(var_s, 1e-18)) if with_scale else 1.0
    t = mu_t - scale * (R @ mu_s)
    return scale * est @ R.T + t


def compute_ate(est: np.ndarray, gt: np.ndarray, align: bool = True) -> float:
    """RMSE of aligned absolute positions. Parity: ``evaluate_trajectory.py:56-65``."""
    n = min(len(est), len(gt))
    if n < 2:
        return 0.0
    aligned = align_trajectories(est, gt) if align else np.asarray(est[:n], dtype=np.float64)
    err = np.linalg.norm(aligned - np.asarray(gt[:n]), axis=1)
    return float(np.sqrt(np.mean(err**2)))


def compute_rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1) -> float:
    """RMSE of relative displacement errors. Parity: ``evaluate_trajectory.py:68-78``."""
    n = min(len(est), len(gt))
    if n <= delta:
        return 0.0
    est = np.asarray(est[:n], dtype=np.float64)
    gt = np.asarray(gt[:n], dtype=np.float64)
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def compute_additional_metrics(est: np.ndarray, gt: np.ndarray, rpe_delta: int = 1) -> Dict[str, float]:
    """ATE/RPE {RMSE, MEAN, MEDIAN}. Parity: ``evaluate_trajectory.py:81-116``."""
    n = min(len(est), len(gt))
    out = {
        "ATE_RMSE": 0.0, "ATE_MEAN": 0.0, "ATE_MEDIAN": 0.0,
        "RPE_RMSE": 0.0, "RPE_MEAN": 0.0, "RPE_MEDIAN": 0.0,
    }
    if n < 2:
        return out
    aligned = align_trajectories(est, gt)
    gt = np.asarray(gt[:n], dtype=np.float64)
    abs_err = np.linalg.norm(aligned - gt, axis=1)
    out["ATE_RMSE"] = float(np.sqrt(np.mean(abs_err**2)))
    out["ATE_MEAN"] = float(np.mean(abs_err))
    out["ATE_MEDIAN"] = float(np.median(abs_err))
    if n > rpe_delta:
        d_est = aligned[rpe_delta:] - aligned[:-rpe_delta]
        d_gt = gt[rpe_delta:] - gt[:-rpe_delta]
        rel_err = np.linalg.norm(d_est - d_gt, axis=1)
        out["RPE_RMSE"] = float(np.sqrt(np.mean(rel_err**2)))
        out["RPE_MEAN"] = float(np.mean(rel_err))
        out["RPE_MEDIAN"] = float(np.median(rel_err))
    return out


def write_metrics_txt(metrics: Dict[str, float], path: Path) -> None:
    Path(path).write_text("".join(f"{k}: {v:.6f}\n" for k, v in sorted(metrics.items())))


def write_metrics_json(metrics: Dict[str, float], path: Path) -> None:
    Path(path).write_text(json.dumps(metrics, indent=2, sort_keys=True))


def write_metrics_csv(metrics: Dict[str, float], path: Path) -> None:
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["metric", "value"])
        for k, v in sorted(metrics.items()):
            writer.writerow([k, f"{v:.6f}"])


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Evaluate an estimated trajectory vs ground truth")
    parser.add_argument("--est", type=Path, required=True)
    parser.add_argument("--gt", type=Path, required=True)
    parser.add_argument("--est-format", default="kitti_odom", choices=sorted(FORMAT_COLUMNS))
    parser.add_argument("--gt-format", default="kitti_odom", choices=sorted(FORMAT_COLUMNS))
    parser.add_argument("--rpe-delta", type=int, default=1)
    parser.add_argument("--out", type=Path, default=None, help="report path (.txt/.json/.csv)")
    args = parser.parse_args(argv)
    est = load_trajectory_file(args.est, args.est_format)
    gt = load_trajectory_file(args.gt, args.gt_format)
    metrics = compute_additional_metrics(est, gt, args.rpe_delta)
    print(json.dumps(metrics, indent=2, sort_keys=True))
    if args.out:
        suffix = args.out.suffix
        {".txt": write_metrics_txt, ".json": write_metrics_json, ".csv": write_metrics_csv}[
            suffix
        ](metrics, args.out)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
