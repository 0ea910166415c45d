"""Side-by-side GUI viewer: video frame with keypoints + 2-D trajectory.

Parity: reference ``slam_viewer.py`` — matplotlib figure with the current
frame on the left (keypoints and match lines overlaid, inliers green /
outliers red), the x/z trajectory on the right with the latest position
highlighted and padded limits (ref L47-63, L120-131), and a status strip
below with a tracking-health classification, progress bar, and rolling
log (ref L240-300). Works headless with MPLBACKEND=Agg via
``render_frame_png``.

Copied close to verbatim from ``mvslam_tpu/viz/viewer.py``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np


def rotation_to_euler_deg(R: np.ndarray) -> Tuple[float, float, float]:
    """ZYX Euler angles (roll, pitch, yaw) in degrees.

    Parity: ``slam_viewer.py:32-44``.
    """
    R = np.asarray(R)
    sy = math.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if sy > 1e-6:
        roll = math.atan2(R[2, 1], R[2, 2])
        pitch = math.atan2(-R[2, 0], sy)
        yaw = math.atan2(R[1, 0], R[0, 0])
    else:
        roll = math.atan2(-R[1, 2], R[1, 1])
        pitch = math.atan2(-R[2, 0], sy)
        yaw = 0.0
    return math.degrees(roll), math.degrees(pitch), math.degrees(yaw)


def classify_status(num_matches: int, inlier_ratio: float) -> Tuple[str, str]:
    """(status label, hex color) from match density + inlier ratio.

    Parity: ``slam_viewer.py:240-252`` (same thresholds and palette).
    """
    if num_matches < 40:
        return "Low match density", "#f97316"
    if inlier_ratio < 0.2:
        return "Tracking lost", "#dc2626"
    if inlier_ratio < 0.35:
        return "Unstable pose", "#f97316"
    return "Tracking stable", "#16a34a"


def apply_axes_limits(ax, xs, ys, padding: float = 0.25) -> None:
    """Pad axis limits around the trajectory (parity: ``slam_viewer.py:47-63``)."""
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    if xs.size == 0 or ys.size == 0:
        return
    x_pad = max((xs.max() - xs.min()) * padding, 0.5)
    y_pad = max((ys.max() - ys.min()) * padding, 0.5)
    ax.set_xlim(float(xs.min()) - x_pad, float(xs.max()) + x_pad)
    ax.set_ylim(float(ys.min()) - y_pad, float(ys.max()) + y_pad)


class SlamViewer:
    """Incremental viewer over (frame, keypoints, pose) updates.

    ``update`` optionally takes match overlays and a per-frame diagnostics
    record (any object with ``num_features`` / ``num_matches`` /
    ``inlier_ratio`` attributes, e.g. ``slam.api.FrameDiagnostics``) to
    drive the status strip.
    """

    def __init__(self, interactive: bool = True, total_frames: Optional[int] = None) -> None:
        self.interactive = interactive
        self.total_frames = total_frames
        self._fig = None
        self._axes = None
        self._frame_count = 0
        self.trajectory: List[Tuple[float, float]] = []
        self.status_log: List[str] = []
        self.last_status: str = ""

    def _ensure_figure(self):
        import matplotlib

        if not self.interactive:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        if self._fig is None:
            self._fig = plt.figure(figsize=(12, 7), constrained_layout=True)
            grid = self._fig.add_gridspec(2, 2, height_ratios=[3, 1])
            ax_img = self._fig.add_subplot(grid[0, 0])
            ax_traj = self._fig.add_subplot(grid[0, 1])
            ax_status = self._fig.add_subplot(grid[1, :])
            self._axes = (ax_img, ax_traj, ax_status)
            if self.interactive:
                plt.ion()
                plt.show(block=False)
        return self._fig, self._axes

    def update(
        self,
        frame: np.ndarray,
        keypoints: Optional[np.ndarray],
        pose: np.ndarray,
        valid: Optional[np.ndarray] = None,
        matches: Optional[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]] = None,
        diagnostics=None,
    ) -> None:
        fig, (ax_img, ax_traj, ax_status) = self._ensure_figure()
        pose = np.asarray(pose)
        self._frame_count += 1
        self.trajectory.append((float(pose[0, 3]), float(pose[2, 3])))

        # --- left: frame + keypoints + match lines -----------------------
        ax_img.clear()
        ax_img.imshow(np.asarray(frame), cmap="gray")
        if keypoints is not None:
            kp = np.asarray(keypoints)
            if valid is not None:
                kp = kp[np.asarray(valid)]
            if len(kp):
                ax_img.scatter(kp[:, 0], kp[:, 1], s=4, c="lime", alpha=0.7)
        if matches is not None:
            prev_xy, curr_xy, inliers = matches
            prev_xy = np.asarray(prev_xy)
            curr_xy = np.asarray(curr_xy)
            inl = (
                np.asarray(inliers, bool)
                if inliers is not None
                else np.ones(len(prev_xy), bool)
            )
            # Two LineCollections (inliers green, outliers red), not a
            # per-match plot loop: thousands of artists stall the canvas.
            from matplotlib.collections import LineCollection

            segs = np.stack([prev_xy, curr_xy], axis=1)
            for sel, color in ((inl, "#16a34a"), (~inl, "#dc2626")):
                if sel.any():
                    ax_img.add_collection(
                        LineCollection(segs[sel], colors=color, linewidths=0.6, alpha=0.8)
                    )
        roll, pitch, yaw = rotation_to_euler_deg(pose[:3, :3])
        lines = [f"roll {roll:+.1f}°  pitch {pitch:+.1f}°  yaw {yaw:+.1f}°"]
        if diagnostics is not None:
            lines.append(
                f"features {getattr(diagnostics, 'num_features', 0)}  "
                f"matches {getattr(diagnostics, 'num_matches', 0)}  "
                f"inliers {getattr(diagnostics, 'inlier_ratio', 0.0):.2f}"
            )
        pos = pose[:3, 3]
        lines.append(f"pos {pos[0]:+.2f}, {pos[1]:+.2f}, {pos[2]:+.2f}")
        ax_img.set_title("\n".join(lines), fontsize=9)
        ax_img.axis("off")

        # --- right: trajectory with current position highlighted ---------
        ax_traj.clear()
        xs, zs = zip(*self.trajectory)
        if len(self.trajectory) > 1:
            ax_traj.plot(xs, zs, "b-")
        ax_traj.scatter([xs[-1]], [zs[-1]], c="r", zorder=3)
        apply_axes_limits(ax_traj, np.asarray(xs), np.asarray(zs))
        ax_traj.set_xlabel("x [m]")
        ax_traj.set_ylabel("z [m]")
        ax_traj.set_aspect("equal")  # box-adjustable, so the set limits hold
        ax_traj.set_title("trajectory")
        ax_traj.grid(True, linestyle="--", alpha=0.4)

        # --- bottom: status classification + progress + rolling log ------
        ax_status.clear()
        ax_status.set_xlim(0, 1)
        ax_status.set_ylim(0, 1)
        ax_status.axis("off")
        num_matches = int(getattr(diagnostics, "num_matches", 0) or 0)
        inlier_ratio = float(getattr(diagnostics, "inlier_ratio", 0.0) or 0.0)
        status, color = classify_status(num_matches, inlier_ratio)
        self.last_status = status
        ax_status.text(
            0.02, 0.8, f"Status: {status}", fontsize=10, fontweight="bold", color=color
        )
        from matplotlib import patches

        progress = self._frame_count / self.total_frames if self.total_frames else 0.0
        ax_status.add_patch(
            patches.Rectangle(
                (0.02, 0.45), 0.96, 0.12, linewidth=1, edgecolor="#94a3b8", facecolor="none"
            )
        )
        ax_status.add_patch(
            patches.Rectangle(
                (0.02, 0.45), 0.96 * min(progress, 1.0), 0.12, linewidth=0, facecolor="#2563eb"
            )
        )
        ax_status.text(
            0.02,
            0.3,
            f"Progress: {progress * 100:.1f}% ({self._frame_count}/{self.total_frames or '—'})",
            fontsize=9,
        )
        self.status_log.append(
            f"Frame {self._frame_count}: {status} · {num_matches} matches · "
            f"inlier ratio {inlier_ratio:.2f}"
        )
        self.status_log = self.status_log[-4:]
        ax_status.text(0.02, 0.05, "Log:\n" + "\n".join(self.status_log), fontsize=8)

        if self.interactive:
            fig.canvas.draw_idle()
            fig.canvas.flush_events()

    def render_frame_png(self, path) -> None:
        if self._fig is not None:
            self._fig.savefig(path, dpi=100, bbox_inches="tight")
