"""Build persistent map snapshots from live keyframes.

Port of ``mvslam_tpu/loopclosure/map_builder.py``: sample a bounded number
of descriptors (seeded), train the vocabulary (Lloyd iterations on
``device``), compute per-keyframe histograms, emit ``MapBuildStats``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.loopclosure.bow import compute_bow_histogram, train_vocabulary
from mvslam_tpu_torch.loopclosure.persistent_map import MapKeyframe, PersistentMapSnapshot


@dataclass(frozen=True)
class MapBuilderConfig:
    """Same fields and defaults as the reference's (vocab 64, descriptor
    budget 5000)."""

    vocab_size: int = 64
    max_descriptors: int = 5000
    kmeans_iterations: int = 15


@dataclass
class MapBuildStats:
    num_keyframes: int
    num_descriptors_sampled: int
    vocab_size: int


class MapSnapshotBuilder:
    def __init__(self, config: Optional[MapBuilderConfig] = None, key=None, device="cuda") -> None:
        self.config = config or MapBuilderConfig()
        self.device = torch.device(device)
        self._key = key if key is not None else prng.key(0)

    def build_snapshot(self, keyframes) -> Tuple[PersistentMapSnapshot, MapBuildStats]:
        """``keyframes``: objects with frame_id/pose/keypoints/descriptors/valid
        (both ``backend.keyframes.Keyframe`` and ``MapKeyframe`` qualify)."""
        if len(keyframes) < 1:
            raise ValueError("need at least one keyframe")
        all_desc = [kf.descriptors[kf.valid] for kf in keyframes if kf.valid.any()]
        if not all_desc:
            raise ValueError("keyframes contain no valid descriptors")
        desc = np.concatenate(all_desc, axis=0)
        # Deterministic bounded sampling: the numpy seed is the reference's
        # randint draw from the builder's key.
        if len(desc) > self.config.max_descriptors:
            seed = int(prng.randint(self._key.cpu(), (), 0, 2**31 - 1))
            rng = np.random.default_rng(seed)
            pick = rng.choice(len(desc), self.config.max_descriptors, replace=False)
            desc = desc[np.sort(pick)]
        vocab_size = min(self.config.vocab_size, len(desc))
        vocabulary = train_vocabulary(
            desc, self._key, vocab_size, self.config.kmeans_iterations, device=self.device
        )
        histograms = np.stack(
            [compute_bow_histogram(kf.descriptors, kf.valid, vocabulary, device=self.device) for kf in keyframes]
        )
        snapshot = PersistentMapSnapshot(
            keyframes=[
                MapKeyframe(
                    frame_id=int(kf.frame_id),
                    pose=np.asarray(kf.pose, dtype=np.float64),
                    keypoints=np.asarray(kf.keypoints, dtype=np.float32),
                    descriptors=np.asarray(kf.descriptors, dtype=np.uint32),
                    valid=np.asarray(kf.valid, dtype=bool),
                )
                for kf in keyframes
            ],
            vocabulary=vocabulary,
            histograms=histograms,
            frame_ids=np.asarray([kf.frame_id for kf in keyframes], dtype=np.int64),
        )
        stats = MapBuildStats(
            num_keyframes=len(keyframes),
            num_descriptors_sampled=len(desc),
            vocab_size=vocab_size,
        )
        return snapshot, stats
