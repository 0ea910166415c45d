"""What every way of driving ``SLAMSystem`` shares. A traffic file's
``entry`` names the module ``entries/<entry>.py`` whose ``Driver``
(a subclass of :class:`Driver`) drives the window:

- ``setup()`` builds what the window needs and warms the cell's own
  shapes;
- ``window(seconds, tracer)`` drives the program for ``seconds`` and
  returns ``attempted``, ``failed``, the end-to-end ``metrics`` and
  what else it recorded; with a ``tracer``, a stretch runs under the
  device profiler;
- ``answers()``, ``spans()``, ``window_spans()`` and ``extra()`` hand the
  judge and the per-layer readers what the program produced.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import List

import numpy as np

from portbench.reference.judge import ProgramAnswers
from portbench.scene import ping_pong


def system_config(config: dict, traffic: dict, seed: int, output_root: Path, run_id: str):
    from mvslam_tpu_torch.backend.keyframes import KeyframeConfig
    from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
    from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
    from mvslam_tpu_torch.slam.api import SLAMSystemConfig

    cam, pipe = config["camera"], config["pipeline"]
    return SLAMSystemConfig(
        run_id=run_id,
        output_root=output_root,
        seed=int(seed) & 0x7FFFFFFF,
        fx=float(cam["fx"]),
        fy=float(cam["fy"]),
        cx=float(cam["cx"]),
        cy=float(cam["cy"]),
        feature=FeaturePipelineConfig(**pipe["feature"]),
        pose=RobustPoseEstimatorConfig(**pipe["pose"]),
        keyframe=KeyframeConfig(**pipe["keyframe"]),
        **traffic.get("system", {}),
    )


class Driver:
    def __init__(self, name, config, traffic, cell, host_frames, device, seed, output_root):
        from mvslam_tpu_torch.slam.api import SLAMSystem

        self.config, self.traffic, self.cell = config, traffic, cell
        self.frames = host_frames  # (F, H, W) uint8, numpy
        self.rate = float(config["camera"]["rate_hz"])
        self._new_system = lambda run_id: SLAMSystem(
            system_config(config, traffic, seed, output_root, run_id), device=device
        )
        self.system = self._new_system(f"portbench_{name}")
        self.pos = 0  # next stream position
        self.window_diags: List = []
        self.window_unix = [math.inf, -math.inf]  # the untraced window, unix seconds

    def frame(self, p: int) -> np.ndarray:
        return self.frames[ping_pong(p, len(self.frames))]

    def spans(self):
        """The program's telemetry spans: (name, start, end) in unix seconds."""
        return [(e.name, e.timestamp_s - e.duration_s, e.timestamp_s) for e in self.system.telemetry.events()]

    def window_spans(self):
        """The spans inside the untraced window."""
        lo, hi = self.window_unix
        return [s for s in self.spans() if s[1] >= lo and s[2] <= hi]

    def answers(self) -> ProgramAnswers:
        traj = self.system.trajectory
        return ProgramAnswers(
            diags={d.frame_id: d for d in self.window_diags},
            trajectory=dict(zip(traj.frame_ids, (np.asarray(p) for p in traj.poses))),
            keyframes={kf.frame_id: (kf.keypoints, kf.descriptors, kf.valid) for kf in self.system.keyframes.keyframes},
            prev_of=self.prev_of(),
        )

    def extra(self) -> dict:
        return {}
