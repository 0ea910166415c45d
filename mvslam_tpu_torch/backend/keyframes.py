"""Keyframe selection policy and sliding-window bookkeeping.

Parity: reference ``keyframe_manager.py`` — a frame becomes a keyframe if
its motion vs the last keyframe exceeds translation/rotation thresholds or
match quality collapses (ref L65-83); the manager keeps a bounded window
and triggers local bundle adjustment over it (ref L85-118).

Keyframes hold host-side numpy copies of their features (pulled from
device only when a keyframe is actually created — rare relative to frame
rate) so the persistent map/relocalizer can serialize them.

Copied verbatim from ``mvslam_tpu/backend/keyframes.py`` (numpy only).
Descriptors are stored as uint32 words: callers holding the port's int32
descriptor words pass them through ``.view(np.uint32)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np



@dataclass
class Keyframe:
    """Parity: ``keyframe_manager.py:17-23``."""

    frame_id: int
    timestamp: float
    pose: np.ndarray  # (4, 4) world-from-camera
    keypoints: np.ndarray  # (N, 2) float32
    descriptors: np.ndarray  # (N, 8) uint32
    valid: np.ndarray  # (N,) bool

    @property
    def num_features(self) -> int:
        return int(self.valid.sum())


@dataclass(frozen=True)
class KeyframeConfig:
    """Parity thresholds: ``keyframe_manager.py:65-83``."""

    min_translation: float = 0.1
    min_rotation_deg: float = 5.0
    max_match_ratio: float = 0.25
    window_size: int = 5
    max_keyframes: int = 10000


class KeyframeManager:
    """Keyframe policy + sliding window. BA integration is injected as a
    callback so the backend solver stays decoupled (and testable)."""

    def __init__(
        self,
        config: Optional[KeyframeConfig] = None,
        on_window: Optional[Callable[[List[Keyframe]], None]] = None,
    ) -> None:
        self.config = config or KeyframeConfig()
        self.keyframes: List[Keyframe] = []
        self._on_window = on_window

    def __len__(self) -> int:
        return len(self.keyframes)

    @property
    def last(self) -> Optional[Keyframe]:
        return self.keyframes[-1] if self.keyframes else None

    def window(self) -> List[Keyframe]:
        return self.keyframes[-self.config.window_size :]

    def should_add(self, pose: np.ndarray, match_ratio: float) -> bool:
        """Translation/rotation/match-quality policy vs the last keyframe."""
        if not self.keyframes:
            return True
        last = self.keyframes[-1].pose
        rel = np.linalg.inv(last) @ pose
        translation = float(np.linalg.norm(rel[:3, 3]))
        # Pure-numpy geodesic angle: this policy runs per FRAME on the host;
        # a device op here would cost a device round trip per frame.
        cos_theta = np.clip((np.trace(rel[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        rotation = float(np.degrees(np.arccos(cos_theta)))
        return (
            translation >= self.config.min_translation
            or rotation >= self.config.min_rotation_deg
            or match_ratio <= self.config.max_match_ratio
        )

    def add(self, keyframe: Keyframe) -> None:
        self.keyframes.append(keyframe)
        if len(self.keyframes) > self.config.max_keyframes:
            self.keyframes.pop(0)
        if self._on_window is not None and len(self.keyframes) >= 2:
            self._on_window(self.window())

    def maybe_add(
        self,
        frame_id: int,
        timestamp: float,
        pose: np.ndarray,
        match_ratio: float,
        keypoints: np.ndarray,
        descriptors: np.ndarray,
        valid: np.ndarray,
    ) -> Optional[Keyframe]:
        if not self.should_add(pose, match_ratio):
            return None
        kf = Keyframe(
            frame_id=frame_id,
            timestamp=timestamp,
            pose=np.asarray(pose, dtype=np.float64).copy(),
            keypoints=np.asarray(keypoints, dtype=np.float32),
            descriptors=np.asarray(descriptors, dtype=np.uint32),
            valid=np.asarray(valid, dtype=bool),
        )
        self.add(kf)
        return kf
