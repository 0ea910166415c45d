"""Schema-versioned persistent map snapshots + relocalization.

Port of ``mvslam_tpu/loopclosure/persistent_map.py``:
``MapKeyframe(frame_id, pose, keypoints, descriptors, valid)``,
``PersistentMapSnapshot`` with BoW vocabulary/histograms/frame_ids and a
``stable_hash`` digest, npz + JSON persistence, and ``MapRelocalizer``: BoW
cosine ranking → top-K candidates → descriptor matching → essential-matrix
RANSAC geometric verification → best by (inliers, score, −frame_id).

The npz field names, the dtypes on disk (uint32 descriptors) and the digest
string are the reference's, so a snapshot written by either package loads
in the other with its digest verified. The relocalizer's matching and
RANSAC run on ``device`` (the card unless the caller asks for the CPU); on
the CPU its per-candidate matching takes the C++ host matcher, as the
reference's native branch does (``ops.hamming.matcher_for``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.core.integrity import stable_hash
from mvslam_tpu_torch.geometry.epipolar import decompose_essential
from mvslam_tpu_torch.geometry.projection import normalize_pixels
from mvslam_tpu_torch.loopclosure.bow import compute_bow_histogram
from mvslam_tpu_torch.ops.brief import descriptor_words
from mvslam_tpu_torch.ops.hamming import (
    MatchConfig,
    gather_matched_points,
    matcher_for,
    select_matches,
)
from mvslam_tpu_torch.ops.ransac import RansacConfig, ransac_essential

SCHEMA_VERSION = 1


@dataclass
class MapKeyframe:
    frame_id: int
    pose: np.ndarray  # (4, 4)
    keypoints: np.ndarray  # (N, 2) float32
    descriptors: np.ndarray  # (N, 8) uint32
    valid: np.ndarray  # (N,) bool


@dataclass
class PersistentMapSnapshot:
    keyframes: List[MapKeyframe]
    vocabulary: np.ndarray  # (V, 256) float32
    histograms: np.ndarray  # (K, V)
    frame_ids: np.ndarray  # (K,)
    schema_version: int = SCHEMA_VERSION
    metadata: Dict = field(default_factory=dict)

    def digest(self) -> str:
        return stable_hash(
            {
                "schema_version": self.schema_version,
                "frame_ids": self.frame_ids,
                "vocabulary": self.vocabulary,
                "histograms": self.histograms,
                "poses": np.stack([kf.pose for kf in self.keyframes])
                if self.keyframes
                else np.zeros((0, 4, 4)),
            }
        )


def save_map_snapshot(
    snapshot: PersistentMapSnapshot, arrays_path: Path, metadata_path: Path
) -> None:
    """npz arrays + JSON metadata with digest."""
    kfs = snapshot.keyframes
    np.savez(
        arrays_path,
        vocabulary=snapshot.vocabulary,
        histograms=snapshot.histograms,
        frame_ids=snapshot.frame_ids,
        poses=np.stack([kf.pose for kf in kfs]) if kfs else np.zeros((0, 4, 4)),
        keypoints=np.stack([kf.keypoints for kf in kfs]) if kfs else np.zeros((0, 0, 2), np.float32),
        descriptors=np.stack([kf.descriptors for kf in kfs]) if kfs else np.zeros((0, 0, 8), np.uint32),
        valid=np.stack([kf.valid for kf in kfs]) if kfs else np.zeros((0, 0), bool),
    )
    Path(metadata_path).write_text(
        json.dumps(
            {
                "schema_version": snapshot.schema_version,
                "num_keyframes": len(kfs),
                "vocab_size": int(snapshot.vocabulary.shape[0]),
                "digest": snapshot.digest(),
                **snapshot.metadata,
            },
            indent=2,
            sort_keys=True,
        )
    )


def load_map_snapshot(arrays_path: Path, metadata_path: Path) -> PersistentMapSnapshot:
    """Load a snapshot (schema check + digest verify)."""
    meta = json.loads(Path(metadata_path).read_text())
    version = int(meta.get("schema_version", -1))
    if version != SCHEMA_VERSION:
        raise ValueError(f"unsupported map schema version {version} (expected {SCHEMA_VERSION})")
    with np.load(arrays_path, allow_pickle=False) as data:
        kfs = [
            MapKeyframe(
                frame_id=int(data["frame_ids"][k]),
                pose=np.asarray(data["poses"][k]),
                keypoints=np.asarray(data["keypoints"][k]),
                descriptors=np.asarray(data["descriptors"][k]),
                valid=np.asarray(data["valid"][k]),
            )
            for k in range(data["poses"].shape[0])
        ]
        snapshot = PersistentMapSnapshot(
            keyframes=kfs,
            vocabulary=np.asarray(data["vocabulary"]),
            histograms=np.asarray(data["histograms"]),
            frame_ids=np.asarray(data["frame_ids"]),
            schema_version=version,
            metadata={k: v for k, v in meta.items() if k not in ("schema_version", "digest")},
        )
    expected = meta.get("digest")
    if expected and snapshot.digest() != expected:
        raise ValueError("map snapshot digest mismatch (corrupted or tampered)")
    return snapshot


class MapRelocalizer:
    """BoW → candidate keyframes → geometric verification, on ``device``."""

    def __init__(
        self,
        snapshot: PersistentMapSnapshot,
        K: np.ndarray,
        min_inliers: int = 20,
        max_candidates: int = 5,
        ransac_threshold_px: float = 2.0,
        key=None,
        device_index: bool = False,
        device="cuda",
    ) -> None:
        self.snapshot = snapshot
        self.K = np.asarray(K, dtype=np.float64)
        self.min_inliers = min_inliers
        self.max_candidates = max_candidates
        self.ransac_threshold_px = ransac_threshold_px
        self.device = torch.device(device)
        self._key = (key if key is not None else prng.key(0)).to(self.device)
        matcher_for(self.device)  # on the CPU: builds the C++ matcher now, not in the first search
        self._device_index = None
        if device_index and len(snapshot.keyframes):
            # Bulk-load the snapshot's histograms into device memory once;
            # every relocalize() then scores with a device matvec instead
            # of a host matvec over the whole map.
            self._device_index = self._build_index()

    def _build_index(self):
        from mvslam_tpu_torch.loopclosure.device_index import DeviceBoWIndex

        return DeviceBoWIndex.from_histograms(
            self.snapshot.frame_ids, self.snapshot.histograms, device=self.device
        )

    def _put(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=self.device)

    def relocalize(
        self,
        keypoints: np.ndarray,
        descriptors: np.ndarray,
        valid: np.ndarray,
    ) -> Optional[Tuple[np.ndarray, np.ndarray, Dict]]:
        """Returns (keyframe_pose, relative_transform, info) or None.

        ``pose_query = keyframe_pose @ relative_transform`` re-anchors the
        pose chain.
        """
        snap = self.snapshot
        if not snap.keyframes:
            return None
        hist = compute_bow_histogram(descriptors, valid, snap.vocabulary, device=self.device)
        if self._device_index is not None:
            if len(self._device_index) != len(snap.keyframes):
                # The snapshot was swapped/extended after construction:
                # rebuild the device copy rather than silently scoring
                # stale rows (and truncating to the stale length).
                self._device_index = self._build_index()
            scores = self._device_index.scores(hist)
        else:
            scores = snap.histograms @ hist
        order = sorted(
            range(len(scores)), key=lambda i: (-float(scores[i]), int(snap.frame_ids[i]))
        )[: self.max_candidates]

        Kt = self._put(self.K, torch.float32)
        q_desc = descriptor_words(descriptors, self.device)
        q_valid = self._put(np.asarray(valid, bool))
        q_xy = self._put(keypoints, torch.float32)
        fx = float(self.K[0, 0])

        # On the CPU the per-candidate matching runs in the C++ matcher.
        match = matcher_for(self.device)
        best = None
        for idx in order:
            kf = snap.keyframes[idx]
            res = match(
                descriptor_words(kf.descriptors, self.device),
                self._put(np.asarray(kf.valid, bool)),
                q_desc,
                q_valid,
                MatchConfig(cross_check=True),
            )
            sel = select_matches(res, max_matches=256)
            if int(sel.num_valid) < 8:
                continue
            p_kf, p_q = gather_matched_points(self._put(kf.keypoints, torch.float32), q_xy, sel)
            n1 = normalize_pixels(p_kf, Kt)
            n2 = normalize_pixels(p_q, Kt)
            ransac = ransac_essential(
                prng.fold_in(self._key, int(kf.frame_id)),
                n1,
                n2,
                sel.valid,
                RansacConfig(num_hypotheses=256, min_inliers=self.min_inliers),
                threshold=self.ransac_threshold_px / fx,
            )
            num_inliers = int(ransac.num_inliers)
            if not bool(ransac.success) or num_inliers < self.min_inliers:
                continue
            entry = (num_inliers, float(scores[idx]), -int(kf.frame_id), idx, ransac, n1, n2)
            if best is None or entry[:3] > best[:3]:
                best = entry
        if best is None:
            return None
        num_inliers, score, _, idx, ransac, n1, n2 = best
        kf = snap.keyframes[idx]
        R, t, _ = decompose_essential(
            ransac.model, n1, n2, weights=ransac.inliers.to(torch.float32)
        )
        R = R.cpu().numpy().astype(np.float64)
        t = t.cpu().numpy().astype(np.float64)
        rel = np.eye(4)
        rel[:3, :3] = R.T
        rel[:3, 3] = -R.T @ t
        info = {
            "matched_keyframe": int(kf.frame_id),
            "num_inliers": num_inliers,
            "bow_score": score,
        }
        return kf.pose.copy(), rel, info
