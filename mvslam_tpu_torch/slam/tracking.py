"""The fused per-frame tracking step.

Port of the tracking path of ``mvslam_tpu/slam/tracking.py``: detect and
describe a window of frames (batched, both CUDA kernels), match each frame
against its predecessor, estimate the dual-model pose of every pair
(batched), and pack every host-needed scalar and the new features into
single buffers with the reference's exact layouts, so host code written
against the JAX package reads the port's output unchanged.

``track_superwindow`` runs its windows in a Python loop (the reference's
``lax.scan``, ``track_superwindow_chunked``); every stage inside a window
is batched over the window. With a ``window_sharding`` each window's frames
are split over a mesh (``parallel.mesh.track_superwindow_meshed``).

``track_frame_flow`` is the flow-first step (pose from pyramidal LK tracks
of the previous keypoints, ``ops.lk``), and ``match_and_estimate`` the
matching fallback over two already-extracted feature sets.

Given a ``recorder``, the feature-matching steps time their three stages
on the device (``core.telemetry.device_span``): ``detect`` (K1, K2,
BRIEF), ``match`` (matching, selection, gathering the matched points) and
``pose`` (the pose stage through the packed outputs), once per window.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder, device_span, timed_event
from mvslam_tpu_torch.core.sharding import NamedSharding, blocks, concat
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig, FeatureSet
from mvslam_tpu_torch.frontend.pose_estimator import (
    DevicePoseResult,
    RobustPoseEstimatorConfig,
    estimate_pose_device,
)
from mvslam_tpu_torch.ops.brief import BriefConfig
from mvslam_tpu_torch.ops.detect import detect_and_describe
from mvslam_tpu_torch.ops.fast import FastConfig
from mvslam_tpu_torch.ops.hamming import (
    MatchConfig,
    gather_matched_points,
    match_descriptors,
    select_matches,
)
from mvslam_tpu_torch.ops.image import rgb_to_gray
from mvslam_tpu_torch.ops.lk import LKConfig, lk_track

_SCALAR_FIELDS = (
    "use_essential",
    "num_inliers",
    "inlier_ratio",
    "median_parallax_deg",
    "cheirality_ratio",
    "score",
    "essential_score",
    "homography_score",
    "median_displacement_px",
    "homography_share",
    "num_valid_matches",
)


def _pack_values(pose: DevicePoseResult, num_matches, num_features) -> torch.Tensor:
    """Every host-needed scalar in ONE f32 array (..., 25): rotation (9),
    translation (3), ``_SCALAR_FIELDS``, num_matches, num_features."""
    parts = [pose.rotation.reshape(*pose.rotation.shape[:-2], 9), pose.translation]
    for name in _SCALAR_FIELDS:
        parts.append(getattr(pose, name).to(torch.float32)[..., None])
    parts.append(num_matches.to(torch.float32)[..., None])
    parts.append(num_features.to(torch.float32)[..., None])
    return torch.cat([p.to(torch.float32) for p in parts], dim=-1)


def _pack_features(feats: FeatureSet) -> torch.Tensor:
    """(..., N, 11) f32: [x, y, valid, desc-bits×8], descriptors bitcast
    (bit-preserving) into f32 lanes."""
    desc_bits = feats.descriptors.contiguous().view(torch.float32)
    return torch.cat([feats.xy, feats.valid.to(torch.float32)[..., None], desc_bits], dim=-1)


def unpack_features(packed: np.ndarray):
    """Host-side inverse of :func:`_pack_features` → (xy, descriptors uint32, valid)."""
    packed = np.ascontiguousarray(packed, dtype=np.float32)
    xy = packed[..., 0:2]
    valid = packed[..., 2] > 0.5
    desc = np.ascontiguousarray(packed[..., 3:11]).view(np.uint32)
    return xy, desc, valid


class TrackResult(NamedTuple):
    """Per-pair outputs (leading axes: the pairs tracked)."""

    pose: DevicePoseResult
    matched_p1: torch.Tensor  # (..., M, 2) pixel coords in prev frame
    matched_p2: torch.Tensor  # (..., M, 2) pixel coords in new frame
    match_mask: torch.Tensor  # (..., M) bool
    match_distances: torch.Tensor  # (..., M)
    num_matches: torch.Tensor  # (...) int32
    num_features: torch.Tensor  # (...) int32 valid keypoints in new frame
    scalars_packed: torch.Tensor  # (..., 14 + len(_SCALAR_FIELDS)) f32 — see _pack_values
    features_packed: torch.Tensor  # (..., N, 11) f32 — see _pack_features


def _configs(feature_config: FeaturePipelineConfig):
    fast = FastConfig(threshold=feature_config.fast_threshold, grid_cells=feature_config.grid_cells)
    brief = BriefConfig(blur_sigma=feature_config.blur_sigma)
    match = MatchConfig(
        ratio=feature_config.ratio,
        cross_check=feature_config.cross_check,
        use_ratio_test=feature_config.use_ratio_test,
    )
    return fast, brief, match


def _detect_describe(frames: torch.Tensor, feature_config: FeaturePipelineConfig) -> FeatureSet:
    """(B, H, W) gray or (B, H, W, 3) colour frames → batched FeatureSet.

    Integer gray frames also feed the FAST score map's exact integer path.
    """
    fast, brief, _ = _configs(feature_config)
    color = frames.ndim == 4
    gray = rgb_to_gray(frames) if color else frames.to(torch.float32)
    integral = not frames.dtype.is_floating_point and frames.dtype != torch.bool
    xy, scores, desc, angles, valid = detect_and_describe(
        gray,
        feature_config.num_features,
        fast,
        brief,
        num_levels=feature_config.num_pyramid_levels,
        score_image=frames if (integral and not color) else None,
    )
    return FeatureSet(xy, scores, desc, angles, valid)


def _index(tree, i):
    """Index every tensor leaf of a (nested) NamedTuple."""
    if isinstance(tree, tuple):
        return type(tree)(*(_index(x, i) for x in tree))
    return tree[i]


def _stack(trees):
    """Stack a list of (nested) NamedTuples leaf by leaf along a new axis 0."""
    first = trees[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack([t[k] for t in trees]) for k in range(len(first))))
    return torch.stack(trees)


def bootstrap_frame(frame: torch.Tensor, feature_config: FeaturePipelineConfig) -> FeatureSet:
    """Detect+describe the first frame (H, W[, 3]) — nothing to track against."""
    return _index(_detect_describe(frame[None], feature_config), 0)


frame_to_gray = rgb_to_gray  # (H, W[, 3]) frame → the flow path's (H, W) float32 image


def _track_pairs(
    keys: torch.Tensor,
    f1: FeatureSet,
    f2: FeatureSet,
    K: torch.Tensor,
    feature_config: FeaturePipelineConfig,
    pose_config: RobustPoseEstimatorConfig,
    recorder: Optional[RunTelemetryRecorder] = None,
) -> TrackResult:
    """Match f1 → f2 and estimate each pair's pose (batched over pairs)."""
    _, _, match_cfg = _configs(feature_config)
    with device_span(recorder, "match", keys.device):
        result = match_descriptors(f1.descriptors, f1.valid, f2.descriptors, f2.valid, match_cfg)
        selected = select_matches(result, max_matches=feature_config.max_matches)
        p1, p2 = gather_matched_points(f1.xy, f2.xy, selected)
    with device_span(recorder, "pose", keys.device):
        pose = estimate_pose_device(keys, p1, p2, selected.valid, K, pose_config)
        num_features = f2.valid.sum(dim=-1).to(torch.int32)
        return TrackResult(
            pose=pose,
            matched_p1=p1,
            matched_p2=p2,
            match_mask=selected.valid,
            match_distances=selected.distances,
            num_matches=selected.num_valid,
            num_features=num_features,
            scalars_packed=_pack_values(pose, selected.num_valid, num_features),
            features_packed=_pack_features(f2),
        )


def track_frame(
    key: torch.Tensor,
    prev_features: FeatureSet,
    frame: torch.Tensor,
    K: torch.Tensor,
    feature_config: FeaturePipelineConfig,
    pose_config: RobustPoseEstimatorConfig,
    recorder: Optional[RunTelemetryRecorder] = None,
) -> Tuple[FeatureSet, TrackResult]:
    """Detect+describe one frame, match it against ``prev_features`` and
    estimate the pose, with ``key`` used as is (no frame-id fold)."""
    with device_span(recorder, "detect", frame.device):
        features = _detect_describe(frame[None], feature_config)
    prev = _stack([prev_features])
    track = _track_pairs(key[None], prev, features, K, feature_config, pose_config, recorder)
    return _index(features, 0), _index(track, 0)


def track_frame_flow(
    key: torch.Tensor,
    prev_gray: torch.Tensor,
    prev_features: FeatureSet,
    frame: torch.Tensor,
    K: torch.Tensor,
    feature_config: FeaturePipelineConfig,
    pose_config: RobustPoseEstimatorConfig,
    lk_config: Optional[LKConfig] = None,
) -> Tuple[torch.Tensor, FeatureSet, TrackResult]:
    """Flow-first tracking: the pose comes from pyramidal LK tracks of the
    previous frame's keypoints; the new frame's features are still
    detected (keyframes and the matching fallback need them).

    Returns ``(gray, features, track)``: ``gray`` seeds the next call's
    ``prev_gray``; ``track.num_matches`` counts valid LK tracks.
    """
    lk_config = lk_config or LKConfig()
    gray = rgb_to_gray(frame)
    features = _index(_detect_describe(frame[None], feature_config), 0)
    nxt_pts, residuals, flow_valid = lk_track(
        prev_gray, gray, prev_features.xy, prev_features.valid, lk_config
    )
    pose = _index(
        estimate_pose_device(key[None], prev_features.xy[None], nxt_pts[None], flow_valid[None], K, pose_config),
        0,
    )
    num_tracks = flow_valid.sum().to(torch.int32)
    num_features = features.valid.sum().to(torch.int32)
    track = TrackResult(
        pose=pose,
        matched_p1=prev_features.xy,
        matched_p2=nxt_pts,
        match_mask=flow_valid,
        match_distances=residuals,
        num_matches=num_tracks,
        num_features=num_features,
        scalars_packed=_pack_values(pose, num_tracks, num_features),
        features_packed=_pack_features(features),
    )
    return gray, features, track


def match_and_estimate(
    key: torch.Tensor,
    prev_features: FeatureSet,
    cur_features: FeatureSet,
    K: torch.Tensor,
    feature_config: FeaturePipelineConfig,
    pose_config: RobustPoseEstimatorConfig,
    recorder: Optional[RunTelemetryRecorder] = None,
) -> TrackResult:
    """Match two already-extracted feature sets and estimate the pose,
    with ``key`` used as is."""
    track = _track_pairs(
        key[None], _stack([prev_features]), _stack([cur_features]), K, feature_config, pose_config, recorder
    )
    return _index(track, 0)


def feature_set_from_arrays(xy, descriptors, valid, *, device) -> FeatureSet:
    """Host arrays ``(xy (N, 2), descriptors (N, 8) uint32, valid (N,))`` →
    a FeatureSet on ``device`` (no default: the caller names the device its
    tracking runs on), descriptor words reinterpreted as int32."""
    n = len(valid)
    words = np.ascontiguousarray(descriptors, dtype=np.uint32).view(np.int32)
    return FeatureSet(
        xy=torch.tensor(np.asarray(xy, dtype=np.float32), device=device),
        scores=torch.zeros((n,), dtype=torch.float32, device=device),
        descriptors=torch.tensor(words, device=device),
        angles=torch.zeros((n,), dtype=torch.float32, device=device),
        valid=torch.tensor(np.asarray(valid, dtype=bool), device=device),
    )


def _to(tree, device):
    """Every tensor leaf of a (nested) NamedTuple on ``device``."""
    if isinstance(tree, tuple):
        return type(tree)(*(_to(x, device) for x in tree))
    return tree.to(device)


def _concat(trees, device):
    """Concatenate per-slot (nested) NamedTuples leaf by leaf along axis 0
    on ``device``, in slot order."""
    first = trees[0]
    if isinstance(first, tuple):
        return type(first)(*(_concat([t[k] for t in trees], device) for k in range(len(first))))
    return concat(trees, device)


def track_window(
    key: torch.Tensor,
    prev_features: FeatureSet,
    frames: torch.Tensor,
    K: torch.Tensor,
    feature_config: FeaturePipelineConfig,
    pose_config: RobustPoseEstimatorConfig,
    start_index: int = 0,
    window_sharding: Optional[NamedSharding] = None,
    recorder: Optional[RunTelemetryRecorder] = None,
) -> Tuple[FeatureSet, TrackResult]:
    """Track a window (B, H, W) of consecutive frames: pair i matches frame
    i-1 (``prev_features`` for i = 0) to frame i.

    Per-pair keys fold the GLOBAL frame id ``start_index + i`` into ``key``,
    so windowed and frame-by-frame runs draw the same hypotheses. Returns
    (features of every frame, leading axis B — index -1 seeds the next
    window, and the TrackResult with leading axis B).

    ``window_sharding`` splits the frames into its mesh's blocks: slot s
    detects, matches and estimates its block on its device, its first pair
    taking slot s−1's last FeatureSet (slot 0's: ``prev_features``) — the
    reference's boundary collective-permute. Results come back on slot 0's
    device in frame order.
    """
    if window_sharding is not None:
        return _track_window_sharded(
            key, prev_features, frames, K, feature_config, pose_config, int(start_index), window_sharding, recorder
        )
    with device_span(recorder, "detect", frames.device):
        feats = _detect_describe(frames, feature_config)
    src = FeatureSet(*(torch.cat([p[None], f[:-1]], dim=0) for p, f in zip(prev_features, feats)))
    ids = int(start_index) + torch.arange(frames.shape[0], device=frames.device)
    keys = prng.fold_in(key.to(frames.device), ids)
    return feats, _track_pairs(keys, src, feats, K, feature_config, pose_config, recorder)


def _track_window_sharded(key, prev_features, frames, K, feature_config, pose_config, start_index, sharding, recorder):
    mesh = sharding.mesh
    carry = prev_features
    feats_parts, track_parts = [], []
    for (lo, hi), dev in zip(blocks(frames.shape[0], mesh.size, "window"), mesh.devices):
        feats, track = track_window(
            key.to(dev), _to(carry, dev), frames[lo:hi].to(dev), K.to(dev), feature_config, pose_config,
            start_index=start_index + lo, recorder=recorder,
        )
        carry = _index(feats, -1)
        feats_parts.append(feats)
        track_parts.append(track)
    home = mesh.devices[0]
    return _concat(feats_parts, home), _concat(track_parts, home)


def track_superwindow(
    key: torch.Tensor,
    prev_features: FeatureSet,
    frames: torch.Tensor,
    K: torch.Tensor,
    feature_config: FeaturePipelineConfig,
    pose_config: RobustPoseEstimatorConfig,
    window: int = 16,
    start_index: int = 0,
    recorder: Optional[RunTelemetryRecorder] = None,
) -> Tuple[FeatureSet, TrackResult]:
    """Track S·window frames (S·window, H, W) as S consecutive windows.

    Returns the final frame's FeatureSet (seeds the next call) and a
    TrackResult whose leaves have leading axes (S, window).
    """
    if frames.shape[0] % window != 0:
        raise ValueError("frames length must be a multiple of window")
    num_windows = frames.shape[0] // window
    chunks = frames.reshape(num_windows, window, *frames.shape[1:])
    starts = [int(start_index) + window * w for w in range(num_windows)]
    return track_superwindow_chunked(
        key, prev_features, chunks, K, feature_config, pose_config, starts, recorder=recorder
    )


def track_superwindow_chunked(
    key: torch.Tensor,
    prev_features: FeatureSet,
    chunks: torch.Tensor,
    K: torch.Tensor,
    feature_config: FeaturePipelineConfig,
    pose_config: RobustPoseEstimatorConfig,
    starts,
    window_sharding: Optional[NamedSharding] = None,
    recorder: Optional[RunTelemetryRecorder] = None,
) -> Tuple[FeatureSet, TrackResult]:
    """The window loop of :func:`track_superwindow` over pre-chunked windows
    (S, window, H, W), ``starts`` the global frame id of each window's first
    frame (ints or an (S,) tensor). The carry is the previous window's last
    FeatureSet; ``window_sharding`` splits each window over a mesh (see
    :func:`track_window`), which leaves every per-pair key, and so every
    hypothesis set, as it is unsharded.
    """
    tracks = []
    prev = prev_features
    for chunk, start in zip(chunks, [int(s) for s in starts]):
        feats, track = track_window(
            key, prev, chunk, K, feature_config, pose_config, start_index=start, window_sharding=window_sharding,
            recorder=recorder,
        )
        prev = _index(feats, -1)
        tracks.append(track)
    return prev, _stack(tracks)


_FEATURE_FETCH_CACHE: "OrderedDict[int, tuple]" = OrderedDict()
_FEATURE_FETCH_CACHE_CAP = 8


def pull_features(track: TrackResult, recorder: Optional[RunTelemetryRecorder] = None):
    """Numpy (xy, descriptors uint32, valid) of the tracked frame(s).

    ONE device-to-host copy per ``features_packed`` buffer (LRU keyed by
    the tensor's id): every keyframe of a window reads the same copy. The
    copy, where it happens, is the span ``keyframe_pull``.
    """
    buf = track.features_packed
    key = id(buf)
    entry = _FEATURE_FETCH_CACHE.get(key)
    # The entry holds its buffer: while it lives, its id cannot be reused,
    # and the identity check makes a reused id after eviction harmless.
    if entry is None or entry[0] is not buf:
        with timed_event(recorder, "keyframe_pull", metadata={"bytes": buf.numel() * buf.element_size()}):
            entry = (buf, unpack_features(buf.cpu().numpy()))
        _FEATURE_FETCH_CACHE[key] = entry
        while len(_FEATURE_FETCH_CACHE) > _FEATURE_FETCH_CACHE_CAP:
            _FEATURE_FETCH_CACHE.popitem(last=False)
    else:
        _FEATURE_FETCH_CACHE.move_to_end(key)
    return entry[1]


def pull_scalars(track: TrackResult) -> dict:
    """Every scalar the host control flow needs, as numpy arrays shaped
    like the TrackResult's leading axes."""
    packed = track.scalars_packed.cpu().numpy()
    rotation = packed[..., :9].reshape(*packed.shape[:-1], 3, 3)
    translation = packed[..., 9:12]
    out = {"rotation": rotation, "translation": translation}
    for k, name in enumerate(_SCALAR_FIELDS):
        out[name] = packed[..., 12 + k]
    counts_at = 12 + len(_SCALAR_FIELDS)
    out["num_matches"] = packed[..., counts_at]
    out["num_features"] = packed[..., counts_at + 1]
    out["use_essential"] = out["use_essential"] > 0.5
    return out
