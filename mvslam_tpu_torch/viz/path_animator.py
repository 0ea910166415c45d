"""Live 2-D trajectory animation in a background thread.

Parity: reference ``slam_path_estimator.py`` — a matplotlib animator fed
incrementally with pose estimates; yaw smoothed by clamping to ±max_deg
per frame (ref L105-117); draws the estimate, an optional optimized
overlay, loop-closure edges, and a heading arrow (ref L145-203).

matplotlib is a gated host dependency; headless environments can use
:class:`TrajectoryRecorder` (same API, no window) or ``render_png``.
Without matplotlib the animator's thread returns at once and only its
recorder runs.

Copied close to verbatim from ``mvslam_tpu/viz/path_animator.py``.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np


def clamp_yaw_rate(prev_yaw: float, new_yaw: float, max_step_deg: float = 5.0) -> float:
    """Limit yaw change per frame (parity: ``slam_path_estimator.py:105-117``)."""
    delta = math.atan2(math.sin(new_yaw - prev_yaw), math.cos(new_yaw - prev_yaw))
    limit = math.radians(max_step_deg)
    return prev_yaw + max(-limit, min(limit, delta))


@dataclass
class TrajectoryRecorder:
    """Headless accumulator with the animator's update API."""

    positions: List[Tuple[float, float]] = field(default_factory=list)
    optimized: List[Tuple[float, float]] = field(default_factory=list)
    loop_edges: List[Tuple[int, int]] = field(default_factory=list)
    yaw: float = 0.0
    max_yaw_step_deg: float = 5.0

    def update(self, pose: np.ndarray) -> None:
        pose = np.asarray(pose)
        x, z = float(pose[0, 3]), float(pose[2, 3])
        yaw = math.atan2(float(pose[0, 2]), float(pose[2, 2]))
        self.yaw = clamp_yaw_rate(self.yaw, yaw, self.max_yaw_step_deg)
        self.positions.append((x, z))

    def set_optimized(self, positions: Sequence[Tuple[float, float]]) -> None:
        self.optimized = list(positions)

    def add_loop_edge(self, i: int, j: int) -> None:
        self.loop_edges.append((int(i), int(j)))


class VehiclePathLiveAnimator(TrajectoryRecorder):
    """Matplotlib live animator (background thread redraw loop).

    Parity: ``slam_path_estimator.py:16-213``.
    """

    def __init__(self, interval_s: float = 0.2, max_yaw_step_deg: float = 5.0) -> None:
        super().__init__(max_yaw_step_deg=max_yaw_step_deg)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, name="path-animator", daemon=True)
        self._thread.start()

    def update(self, pose: np.ndarray) -> None:
        with self._lock:
            super().update(pose)

    def _draw(self, ax) -> None:
        with self._lock:
            positions = list(self.positions)
            optimized = list(self.optimized)
            edges = list(self.loop_edges)
            yaw = self.yaw
        ax.clear()
        if positions:
            xs, zs = zip(*positions)
            ax.plot(xs, zs, "b-", linewidth=1.5, label="estimate")
            for i, j in edges:
                if i < len(positions) and j < len(positions):
                    ax.plot(
                        [positions[i][0], positions[j][0]],
                        [positions[i][1], positions[j][1]],
                        "g--",
                        linewidth=0.8,
                    )
            # Heading arrow at the latest pose.
            x, z = positions[-1]
            ax.annotate(
                "",
                xy=(x + 2 * math.sin(yaw), z + 2 * math.cos(yaw)),
                xytext=(x, z),
                arrowprops=dict(arrowstyle="->", color="red"),
            )
        if optimized:
            xs, zs = zip(*optimized)
            ax.plot(xs, zs, "r-", linewidth=1.0, alpha=0.7, label="optimized")
        ax.set_xlabel("x [m]")
        ax.set_ylabel("z [m]")
        ax.set_aspect("equal", adjustable="datalim")
        ax.legend(loc="upper right")

    def _run(self) -> None:
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots(figsize=(6, 6))
        plt.ion()
        plt.show(block=False)
        while not self._stop.is_set():
            self._draw(ax)
            fig.canvas.draw_idle()
            fig.canvas.flush_events()
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def render_png(self, path) -> None:
        """Headless one-shot render (MPLBACKEND=Agg friendly)."""
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 6))
        self._draw(ax)
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
