"""SLAMSystem — the public entry point.

Port of ``mvslam_tpu/slam/api.py``: per-frame tracking with the fused
tracking step (``slam.tracking``), host-side pose chaining, keyframe
policy, failure handling, deterministic seeds per component, per-frame
diagnostics, telemetry for every stage, and the reference's artifact set
(trajectory npz, metrics, frame diagnostics, telemetry and its summary),
every artifact carrying the ``{seed, config_hash}`` determinism payload.

The device is explicit: ``SLAMSystem(config, device=...)`` runs every
tensor op on that device (kernels K1/K2 on a CUDA device), and nothing
moves to the CPU on its own; windowed bundle adjustment over each keyframe
window (``enable_local_ba``, on by default) runs there too, as do
relocalization after a tracking loss (``enable_relocalization``) and the
map snapshot's vocabulary and histograms (``persist_map_snapshot``): the
default configuration runs whole. ``run_stream_async`` is the live path:
batched extraction on a feature control plane's thread, ordered tracking
behind a tracking control plane (``runtime/``). On the CPU, the matching
off the tracking step (the window-BA pair gate, relocalization, loop
geometry) runs in the port's C++ matcher, equal bit for bit; a system on
the CPU builds that library when it starts.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from mvslam_tpu_torch.backend.bundle_adjustment import WindowBundleAdjuster
from mvslam_tpu_torch.backend.keyframes import Keyframe, KeyframeConfig, KeyframeManager
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.core.determinism import DeterminismRegistry
from mvslam_tpu_torch.core.experiments import create_run_artifacts
from mvslam_tpu_torch.core.persistence import (
    RunDataStore,
    TrajectoryAccumulator,
    summarize_trajectory,
)
from mvslam_tpu_torch.core.telemetry import (
    RunTelemetryRecorder,
    TelemetryCorrelationRegistry,
    timed_event,
)
from mvslam_tpu_torch.eval.telemetry_intelligence import summarize_telemetry_streaming
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig
from mvslam_tpu_torch.frontend.pose_estimator import (
    PoseEstimationFailure,
    RobustPoseEstimatorConfig,
    apply_stability_gates,
)
from mvslam_tpu_torch.loopclosure.map_builder import MapSnapshotBuilder
from mvslam_tpu_torch.loopclosure.persistent_map import (
    MapRelocalizer,
    load_map_snapshot,
    save_map_snapshot,
)
from mvslam_tpu_torch.ops.hamming import matcher_for
from mvslam_tpu_torch.runtime.frame_stream import FramePacket
from mvslam_tpu_torch.slam.tracking import (
    bootstrap_frame,
    frame_to_gray,
    match_and_estimate,
    pull_features,
    pull_scalars,
    track_frame,
    track_frame_flow,
    track_superwindow,
    track_window,
)

logger = logging.getLogger(__name__)

@dataclass(frozen=True)
class SLAMSystemConfig:
    """Same fields and defaults as the reference's config;
    ``program_cache_budget_gb`` is kept for parity and has no effect
    (PyTorch keeps no compiled programs to evict)."""

    run_id: str = "slam_run"
    output_root: Path = Path("runs")
    seed: int = 0
    config_hash: str = ""
    # Camera intrinsics
    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    feature: FeaturePipelineConfig = field(default_factory=FeaturePipelineConfig)
    pose: RobustPoseEstimatorConfig = field(default_factory=RobustPoseEstimatorConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    # Pose source for the single-frame path: "features" (detect+match) or
    # "flow_first" (pyramidal LK tracks with feature-matching fallback).
    pose_source: str = "features"
    flow_min_tracks: int = 30
    # Relocalization
    enable_relocalization: bool = True
    relocalization_min_inliers: int = 20
    # Local BA over the keyframe window, on by default as in the reference.
    enable_local_ba: bool = True
    persist_map_snapshot: bool = True
    program_cache_budget_gb: float = 6.0

    def intrinsics(self) -> np.ndarray:
        return np.asarray(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )


@dataclass
class FrameDiagnostics:
    """Per-frame record; same fields as the reference's."""

    frame_id: int
    timestamp: float
    num_features: int = 0
    num_matches: int = 0
    num_inliers: int = 0
    inlier_ratio: float = 0.0
    parallax: float = 0.0
    cheirality_ratio: float = 0.0
    model_type: str = ""
    pose_success: bool = False
    failure_reason: str = ""
    is_keyframe: bool = False
    relocalized: bool = False
    injected_loss: bool = False
    correlation_id: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


@dataclass(frozen=True)
class SLAMRunResult:
    """Paths and counts of a finalized run; same fields as the reference's."""

    run_dir: Path
    trajectory_path: Path
    metrics_path: Path
    diagnostics_path: Path
    telemetry_path: Path
    telemetry_summary_path: Optional[Path]
    map_snapshot_paths: Optional[Dict[str, Path]]
    num_frames: int
    num_keyframes: int
    num_failures: int
    num_relocalizations: int


class SLAMSystem:
    """Monocular visual SLAM over the fused tracking step, on ``device``."""

    def __init__(self, config: Optional[SLAMSystemConfig] = None, *, device) -> None:
        self.config = config or SLAMSystemConfig()
        self.device = torch.device(device)
        self.registry = DeterminismRegistry(seed=self.config.seed, config_hash=self.config.config_hash)
        self.registry.apply_global_seed()
        arts = create_run_artifacts(
            self.config.output_root, self.config.run_id, metadata=self.registry.metadata()
        )
        self.run_dir = arts.run_dir
        self.store = RunDataStore(self.run_dir, determinism=self.registry.metadata())
        self.telemetry = RunTelemetryRecorder(run_id=self.config.run_id)
        self.correlations = TelemetryCorrelationRegistry(
            self.config.seed, self.config.config_hash, self.config.run_id
        )
        self.keyframes = KeyframeManager(self.config.keyframe, on_window=self._on_keyframe_window)
        self.trajectory = TrajectoryAccumulator()
        self.diagnostics: List[FrameDiagnostics] = []

        self.K = self.config.intrinsics()
        self._K_dev = torch.as_tensor(self.K, dtype=torch.float32, device=self.device)
        self._track_key = self.registry.key_for("tracking", self.device)
        self._pose = np.eye(4, dtype=np.float64)
        self._prev_features = None
        self._prev_gray = None  # device grayscale; only kept for flow_first
        self._frame_count = 0
        self._failure_count = 0
        self._reloc_count = 0
        self._injected_losses: set = set()
        self._relocalizer = None  # set via load_map_snapshot / built on demand
        self._map_snapshot = None
        self._local_ba = (
            WindowBundleAdjuster(self.K, device=self.device, recorder=self.telemetry)
            if self.config.enable_local_ba
            else None
        )
        matcher_for(self.device)  # on the CPU: builds the C++ matcher now, not in the first match

    # ------------------------------------------------------------------
    # Frame processing
    # ------------------------------------------------------------------

    @property
    def pose(self) -> np.ndarray:
        return self._pose.copy()

    def inject_tracking_loss(self, frame_id: int) -> None:
        """Schedule an artificial tracking failure at a frame (chaos hook)."""
        self._injected_losses.add(int(frame_id))

    def process_frame(self, frame: np.ndarray, timestamp: float) -> FrameDiagnostics:
        """Track one frame; returns its diagnostics record."""
        frame_id = self._frame_count
        self._frame_count += 1
        diag = FrameDiagnostics(
            frame_id=frame_id,
            timestamp=float(timestamp),
            correlation_id=self.correlations.correlation_id("frame_process"),
        )
        with timed_event(self.telemetry, "frame_process", metadata={"frame_id": frame_id}):
            # A copy: the caller's array may be read-only, which
            # torch.from_numpy does not take.
            frame_dev = torch.from_numpy(np.array(frame)).to(self.device)
            if self._prev_features is None:
                with timed_event(self.telemetry, "feature_detect", metadata={"frame_id": frame_id}):
                    self._prev_features = bootstrap_frame(frame_dev, self.config.feature)
                    num_feat = int(self._prev_features.valid.sum())
                if self.config.pose_source == "flow_first":
                    self._prev_gray = frame_to_gray(frame_dev)
                diag.num_features = num_feat
                diag.pose_success = True
                diag.model_type = "bootstrap"
                feats = self._prev_features
                self._record_frame(
                    frame_id,
                    timestamp,
                    diag,
                    1.0,
                    lambda: (
                        feats.xy.cpu().numpy(),
                        feats.descriptors.cpu().numpy().view(np.uint32),
                        feats.valid.cpu().numpy(),
                    ),
                )
                return diag

            key = prng.fold_in(self._track_key, frame_id)
            if self.config.pose_source == "flow_first" and self._prev_gray is not None:
                features, track, scalars = self._track_flow_first(key, frame_dev, frame_id)
            else:
                with timed_event(self.telemetry, "track_step", metadata={"frame_id": frame_id}):
                    features, track = track_frame(
                        key,
                        self._prev_features,
                        frame_dev,
                        self._K_dev,
                        self.config.feature,
                        self.config.pose,
                        recorder=self.telemetry,
                    )
                    scalars = pull_scalars(track)

            self._prev_features = features
            self._handle_tracked_frame(
                frame_id, timestamp, diag, scalars, lambda: pull_features(track, self.telemetry)
            )
        return diag

    def _track_flow_first(self, key, frame_dev, frame_id):
        """LK flow pose with feature-matching fallback (single-frame path):
        optical flow first, feature matching second."""
        with timed_event(self.telemetry, "track_step_flow", metadata={"frame_id": frame_id}):
            gray, features, track = track_frame_flow(
                key,
                self._prev_gray,
                self._prev_features,
                frame_dev,
                self._K_dev,
                self.config.feature,
                self.config.pose,
            )
            scalars = pull_scalars(track)
        self._prev_gray = gray

        flow_ok = int(scalars["num_matches"]) >= self.config.flow_min_tracks
        if flow_ok:
            try:
                apply_stability_gates(self.config.pose, self._metrics_from_scalars(scalars))
            except PoseEstimationFailure:
                flow_ok = False
        if flow_ok:
            scalars["_pose_source"] = "flow"
            return features, track, scalars

        with timed_event(self.telemetry, "track_step_fallback", metadata={"frame_id": frame_id}):
            track = match_and_estimate(
                key,
                self._prev_features,
                features,
                self._K_dev,
                self.config.feature,
                self.config.pose,
                self.telemetry,
            )
            scalars = pull_scalars(track)
        return features, track, scalars

    @staticmethod
    def _metrics_from_scalars(scalars) -> Dict[str, Any]:
        return {
            "num_matches": int(scalars["num_matches"]),
            "num_inliers": int(scalars["num_inliers"]),
            "inlier_ratio": float(scalars["inlier_ratio"]),
            "median_parallax_deg": float(scalars["median_parallax_deg"]),
            "cheirality_ratio": float(scalars["cheirality_ratio"]),
            "score": float(scalars["score"]),
            "median_displacement_px": float(scalars["median_displacement_px"]),
        }

    def _handle_tracked_frame(self, frame_id, timestamp, diag, scalars, features_provider) -> None:
        """Host control flow shared by the single-frame and windowed paths:
        gates → pose chain update or failure → keyframes.

        ``features_provider()`` lazily returns numpy ``(xy, descriptors,
        valid)``, fetched from the device only when a keyframe needs them."""
        diag.num_features = int(scalars["num_features"])
        diag.num_matches = int(scalars["num_matches"])
        diag.num_inliers = int(scalars["num_inliers"])
        diag.inlier_ratio = float(scalars["inlier_ratio"])
        diag.parallax = float(scalars["median_parallax_deg"])
        diag.cheirality_ratio = float(scalars["cheirality_ratio"])
        prefix = "flow_" if scalars.get("_pose_source") == "flow" else ""
        diag.model_type = prefix + ("essential" if bool(scalars["use_essential"]) else "homography")

        metrics = self._metrics_from_scalars(scalars)

        try:
            if frame_id in self._injected_losses:
                diag.injected_loss = True
                raise PoseEstimationFailure("injected_tracking_loss", metrics=metrics)
            apply_stability_gates(self.config.pose, metrics)
            R = np.asarray(scalars["rotation"], dtype=np.float64)
            t = np.asarray(scalars["translation"], dtype=np.float64)
            # X2 = R X1 + t ⇒ cam1→cam2; pose chain needs cam2 in world:
            # T_w_c2 = T_w_c1 @ inv([R|t]).
            rel = np.eye(4)
            rel[:3, :3] = R.T
            rel[:3, 3] = -R.T @ t
            self._pose = self._pose @ rel
            diag.pose_success = True
        except PoseEstimationFailure as failure:
            self._failure_count += 1
            diag.pose_success = False
            diag.failure_reason = failure.reason
            logger.warning(
                "pose estimation failed",
                extra={"frame_id": frame_id, "reason": failure.reason},
            )
            if self.config.enable_relocalization:
                diag.relocalized = self._attempt_relocalization(frame_id, features_provider, diag)

        match_ratio = diag.num_matches / max(diag.num_features, 1)
        self._record_frame(frame_id, timestamp, diag, match_ratio, features_provider)

    def _record_frame(
        self,
        frame_id: int,
        timestamp: float,
        diag: FrameDiagnostics,
        match_ratio: float,
        features_provider,
    ) -> None:
        self.trajectory.append(frame_id, timestamp, self._pose)
        if diag.pose_success and features_provider is not None:
            # Feature arrays are pulled from the device only when the policy
            # actually fires (cheap pre-check on pose + match ratio).
            if self.keyframes.should_add(self._pose, match_ratio):
                xy, desc, valid = features_provider()
                kf = self.keyframes.maybe_add(
                    frame_id, timestamp, self._pose, match_ratio, xy, desc, valid
                )
                diag.is_keyframe = kf is not None
        self.diagnostics.append(diag)

    def _on_keyframe_window(self, window: List[Keyframe]) -> None:
        if self._local_ba is None or len(window) < 2:
            return
        old_poses = [kf.pose.copy() for kf in window]
        with timed_event(self.telemetry, "local_ba", metadata={"window": len(window)}):
            result = self._local_ba.refine_window(window, key=self.registry.key_for("local_ba", self.device))
        if result is None or result.diagnostics.conditioning_tripped:
            return
        # Spread each keyframe's rigid correction over its span of recorded
        # frames and re-anchor the live pose at the refined head: otherwise
        # BA would improve the keyframe poses and never the trajectory.
        fid_to_idx = {f: i for i, f in enumerate(self.trajectory.frame_ids)}
        n_traj = len(self.trajectory.poses)
        for k, kf in enumerate(window):
            start = fid_to_idx.get(kf.frame_id)
            if start is None:
                continue
            delta = kf.pose @ np.linalg.inv(old_poses[k])
            end = fid_to_idx.get(window[k + 1].frame_id, n_traj) if k + 1 < len(window) else n_traj
            for idx in range(start, end):
                self.trajectory.poses[idx] = delta @ self.trajectory.poses[idx]
        if n_traj:
            self._pose = self.trajectory.poses[-1].copy()

    # ------------------------------------------------------------------
    # Relocalization (persistent-map path)
    # ------------------------------------------------------------------

    def _new_relocalizer(self) -> MapRelocalizer:
        return MapRelocalizer(
            self._map_snapshot,
            self.K,
            min_inliers=self.config.relocalization_min_inliers,
            key=self.registry.key_for("relocalization", self.device),
            device=self.device,
        )

    def _build_map_snapshot(self) -> None:
        builder = MapSnapshotBuilder(key=self.registry.key_for("map_builder"), device=self.device)
        self._map_snapshot, _ = builder.build_snapshot(self.keyframes.keyframes)

    def load_map_snapshot(self, arrays_path: Path, metadata_path: Path) -> None:
        """Load a persisted map and arm the relocalizer."""
        self._map_snapshot = load_map_snapshot(arrays_path, metadata_path)
        self._relocalizer = self._new_relocalizer()

    def _ensure_relocalizer(self) -> bool:
        """Build a map snapshot + relocalizer from live keyframes on demand.

        Too little map to train a vocabulary on (a ``ValueError`` from the
        builder) means "no relocalizer yet"; any other failure, a device
        error included, propagates."""
        if self._relocalizer is not None:
            return True
        if len(self.keyframes) < 2:
            return False
        try:
            with timed_event(self.telemetry, "map_snapshot_build"):
                self._build_map_snapshot()
                self._relocalizer = self._new_relocalizer()
            return True
        except ValueError as exc:
            logger.warning("relocalizer construction failed", extra={"error": str(exc)})
            return False

    def _attempt_relocalization(self, frame_id: int, features_provider, diag: FrameDiagnostics) -> bool:
        """BoW candidate search + geometric verification; re-anchors pose."""
        if not self._ensure_relocalizer():
            return False
        with timed_event(
            self.telemetry, "relocalization_search", metadata={"frame_id": frame_id}
        ) as meta:
            xy, desc, valid = features_provider()
            hit = self._relocalizer.relocalize(xy, desc, valid)
            meta["success"] = hit is not None
            if hit is None:
                return False
            kf_pose, rel, info = hit
            self._pose = kf_pose @ rel
            self._reloc_count += 1
            meta.update({k: v for k, v in info.items() if np.isscalar(v)})
            return True

    # ------------------------------------------------------------------
    # Runners
    # ------------------------------------------------------------------

    def run_sequence(
        self,
        frames: Sequence[np.ndarray],
        timestamps: Optional[Sequence[float]] = None,
        window: int = 8,
        windows_per_dispatch: int = 1,
        on_frame=None,
    ) -> List[FrameDiagnostics]:
        """Batch-process frames with windowed device dispatch.

        With ``window > 1`` each tracking call covers a whole window of
        consecutive pairs (one scalar pull per window instead of per
        frame); ``windows_per_dispatch > 1`` runs that many windows per
        call (``track_superwindow``). Per-frame RNG folds the global frame
        id, so any window/dispatch shape produces the identical trajectory.
        ``on_frame(diag)`` runs after each frame's host bookkeeping; in
        windowed mode it lags the device by one dispatch, like the rest of
        the host logic.

        Spans (``self.telemetry``): ``run_sequence`` around the call; per
        dispatch ``dispatch_stage`` (pulling, stacking, padding and
        uploading its frames), ``track_enqueue`` (launching its windows;
        their ``detect``/``match``/``pose`` ``.device`` spans are its
        children) and ``scalar_pull``; per frame ``frame_process``, with
        ``keyframe_pull`` inside it where a keyframe pulls features.
        """
        ts = timestamps if timestamps is not None else [float(i) for i in range(len(frames))]
        with timed_event(self.telemetry, "run_sequence", metadata={"frames": len(frames)}):
            return self._run_windowed(zip(frames, ts), window, windows_per_dispatch, on_frame)

    def _run_windowed(
        self, pair_iter, window: int, windows_per_dispatch: int = 1, on_frame=None
    ) -> List[FrameDiagnostics]:
        """Windowed, depth-2-pipelined tracking over an iterator of
        (frame, timestamp) pairs — shared by run_sequence and run_stream."""
        pair_iter = iter(pair_iter)
        if on_frame is None:
            on_frame = lambda diag: None
        if window <= 1:
            diags = []
            for f, t in pair_iter:
                diags.append(self.process_frame(f, t))
                on_frame(diags[-1])
            return diags

        super_windows = max(1, int(windows_per_dispatch))
        dispatch_size = window * super_windows

        diags: List[FrameDiagnostics] = []
        if self._prev_features is None:
            first = next(pair_iter, None)
            if first is None:
                return diags
            diags.append(self.process_frame(first[0], first[1]))
            on_frame(diags[-1])

        exhausted = False

        def stage():
            """Pull up to `dispatch_size` pairs from the iterator; upload them
            (the span ``dispatch_stage``, where there were frames)."""
            nonlocal exhausted
            start = self.telemetry.now()
            chunk, chunk_ts = [], []
            for _ in range(dispatch_size):
                item = next(pair_iter, None)
                if item is None:
                    exhausted = True
                    break
                chunk.append(np.asarray(item[0]))
                chunk_ts.append(float(item[1]))
            if not chunk:
                return None
            real = len(chunk)
            # Pad short tails to the dispatch size by repeating the last
            # frame: padded outputs are ignored, and padded frames detect
            # the real last frame's features, so the carried state holds.
            while len(chunk) < dispatch_size:
                chunk.append(chunk[-1])
            # np.stack already made a fresh array: upload it without a copy.
            stacked = np.stack(chunk)
            frames_dev = torch.from_numpy(stacked).to(self.device)
            self.telemetry.span(
                "dispatch_stage", start, self.telemetry.now(), {"frames": real, "bytes": int(stacked.nbytes)}
            )
            return frames_dev, chunk_ts, real

        def process(inflight) -> None:
            """Pull one dispatch's scalars and run the per-frame host logic."""
            track, chunk_ts, start_id, real = inflight
            with timed_event(self.telemetry, "scalar_pull", metadata={"start": start_id}):
                bundle = pull_scalars(track)  # ONE fetch covers every scalar
            if super_windows > 1:
                # Superwindow leaves are (S, window, ...); flatten to per-frame.
                bundle = {k: v.reshape(dispatch_size, *v.shape[2:]) for k, v in bundle.items()}

            def provider_for(i):
                def provider():
                    xy, desc, valid = pull_features(track, self.telemetry)
                    if super_windows > 1:
                        xy = xy.reshape(dispatch_size, *xy.shape[2:])
                        desc = desc.reshape(dispatch_size, *desc.shape[2:])
                        valid = valid.reshape(dispatch_size, *valid.shape[2:])
                    return xy[i], desc[i], valid[i]

                return provider

            for i in range(real):
                frame_id = start_id + i
                diag = FrameDiagnostics(
                    frame_id=frame_id,
                    timestamp=float(chunk_ts[i]),
                    correlation_id=self.correlations.correlation_id("frame_process"),
                )
                scalars_i = {k: v[i] for k, v in bundle.items()}
                with timed_event(self.telemetry, "frame_process", metadata={"frame_id": frame_id}):
                    self._handle_tracked_frame(frame_id, chunk_ts[i], diag, scalars_i, provider_for(i))
                diags.append(diag)
                on_frame(diag)

        # Depth-2 pipeline: dispatch window i+1 (its previous features are
        # a device-side input, never fetched) BEFORE processing window i,
        # so each pull's device→host copy rides out the next window's
        # compute. Host bookkeeping lags the device by one dispatch; device
        # state never depends on it.
        staged = stage()
        inflight = None
        while staged is not None or inflight is not None:
            new_inflight = None
            if staged is not None:
                frames_dev, chunk_ts, real = staged
                start_id = self._frame_count
                self._frame_count += real
                with timed_event(
                    self.telemetry, "track_enqueue", metadata={"start": start_id, "frames": real}
                ):
                    if super_windows > 1:
                        last, track = track_superwindow(
                            self._track_key,
                            self._prev_features,
                            frames_dev,
                            self._K_dev,
                            self.config.feature,
                            self.config.pose,
                            window=window,
                            start_index=start_id,
                            recorder=self.telemetry,
                        )
                        # Padding repeats the last real frame, so the final
                        # carried FeatureSet equals the real last frame's.
                        self._prev_features = last
                    else:
                        feats, track = track_window(
                            self._track_key,
                            self._prev_features,
                            frames_dev,
                            self._K_dev,
                            self.config.feature,
                            self.config.pose,
                            start_index=start_id,
                            recorder=self.telemetry,
                        )
                        self._prev_features = type(feats)(*(a[real - 1] for a in feats))
                if self.config.pose_source == "flow_first":
                    # Keep the flow path's previous-frame image in sync so a
                    # later single-frame process_frame doesn't flow against a
                    # stale frame.
                    self._prev_gray = frame_to_gray(frames_dev[real - 1])
                staged = stage() if not exhausted else None
                new_inflight = (track, chunk_ts, start_id, real)
            if inflight is not None:
                process(inflight)
            inflight = new_inflight
        return diags

    def run_stream(
        self,
        packets: Iterable[FramePacket],
        window: int = 8,
        windows_per_dispatch: int = 1,
        on_frame=None,
    ) -> List[FrameDiagnostics]:
        """Streamed tracking with the same windowed pipelined engine;
        ``window=1`` gives the per-frame latency path."""
        return self._run_windowed(
            ((p.frame, p.timestamp) for p in packets), window, windows_per_dispatch, on_frame
        )

    def run_stream_async(
        self,
        packets: Iterable[FramePacket],
        feature_control_config=None,
        tracking_control_config=None,
    ) -> List[FrameDiagnostics]:
        """Control-plane path: async feature extraction + ordered tracking.

        Frames enter a ``TrackingControlPlane`` (TTLs, drop policy, breaker)
        in front of a ``FeatureControlPlane`` that extracts them in batches
        on this system's device, on its assembler thread. The ordered
        results go one frame at a time through ``match_and_estimate`` under
        ``fold_in(tracking key, frame id)``, the key ``process_frame`` uses,
        so both paths give one trajectory. On close a ``ControlPlaneHub``
        report of both planes is saved as ``control_plane_report``.

        Spans (``self.telemetry``; each of one frame carries its
        ``frame_id``): ``run_stream_async`` around the call;
        ``input_wait`` around each pull from ``packets``; on the feature
        plane's thread ``feature_queue`` (submit to its batch's start) and
        ``feature_batch`` (one per batch); ``ready_wait`` from the moment
        a frame's features are ready to the start of its tracking, and
        ``frame_process`` around its tracking, with ``track_step`` and
        ``local_ba`` inside.
        """
        from mvslam_tpu_torch.runtime.feature_plane import FeatureControlPlane
        from mvslam_tpu_torch.runtime.hub import ControlPlaneHub, ControlPlaneStageAdapter
        from mvslam_tpu_torch.runtime.tracking_plane import TrackingControlPlane
        from mvslam_tpu_torch.slam.tracking import feature_set_from_arrays

        feature_plane = FeatureControlPlane(
            self.config.feature, feature_control_config, device=self.device, recorder=self.telemetry
        )
        control_plane = TrackingControlPlane(feature_plane, tracking_control_config)
        diags: List[FrameDiagnostics] = []
        prev_fs = self._prev_features

        def handle(result) -> None:
            fr = result.feature_result
            if fr is not None and fr.ready_s is not None:
                self.telemetry.span("ready_wait", fr.ready_s, self.telemetry.now(), {"frame_id": result.seq_id})
            with timed_event(self.telemetry, "frame_process", metadata={"frame_id": result.seq_id}):
                track_result(result)

        def track_result(result) -> None:
            nonlocal prev_fs
            frame_id = result.seq_id
            timestamp = float(result.timestamp)
            diag = FrameDiagnostics(
                frame_id=frame_id,
                timestamp=timestamp,
                correlation_id=self.correlations.correlation_id("frame_process"),
            )
            if not result.ok:
                self._failure_count += 1
                diag.pose_success = False
                diag.failure_reason = result.drop_reason or "feature_error"
                self.trajectory.append(frame_id, timestamp, self._pose)
                self.diagnostics.append(diag)
                diags.append(diag)
                return
            fr = result.feature_result
            cur_fs = feature_set_from_arrays(fr.keypoints, fr.descriptors, fr.valid, device=self.device)
            host_provider = lambda fr=fr: (fr.keypoints, fr.descriptors, fr.valid)
            if prev_fs is None:
                diag.num_features = fr.num_features
                diag.pose_success = True
                diag.model_type = "bootstrap"
                prev_fs = cur_fs
                self._prev_features = cur_fs
                self._record_frame(frame_id, timestamp, diag, 1.0, host_provider)
                diags.append(diag)
                return
            key = prng.fold_in(self._track_key, frame_id)
            with timed_event(self.telemetry, "track_step", metadata={"frame_id": frame_id}):
                track = match_and_estimate(
                    key, prev_fs, cur_fs, self._K_dev, self.config.feature, self.config.pose, self.telemetry
                )
                scalars = pull_scalars(track)
            prev_fs = cur_fs
            self._prev_features = cur_fs
            self._handle_tracked_frame(frame_id, timestamp, diag, scalars, host_provider)
            diags.append(diag)

        def warm(frame: np.ndarray) -> None:
            # Build the kernels and run extraction and match+pose once
            # BEFORE any frame enters the pending buffer: the first build
            # takes seconds and would otherwise tick against every queued
            # frame's TTL, expiring the stream as ``deadline_expired``.
            feature_plane.warmup(frame)
            fs = bootstrap_frame(torch.from_numpy(np.array(frame)).to(self.device), self.config.feature)
            match_and_estimate(self._track_key, fs, fs, self._K_dev, self.config.feature, self.config.pose)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        warmed = False
        packets, end = iter(packets), object()
        try:
            with timed_event(self.telemetry, "run_stream_async"):
                while True:
                    with timed_event(self.telemetry, "input_wait") as meta:
                        packet = next(packets, end)
                        if packet is not end:
                            meta["frame_id"] = self._frame_count
                    if packet is end:
                        break
                    frame = np.asarray(packet.frame)
                    if not warmed:
                        warm(frame)
                        warmed = True
                    frame_id = self._frame_count
                    self._frame_count += 1
                    control_plane.submit_frame(frame_id, packet.timestamp, frame)
                    for result in control_plane.drain_ready():
                        handle(result)
                for result in control_plane.collect():
                    handle(result)
        finally:
            hub = ControlPlaneHub(
                [
                    ControlPlaneStageAdapter(
                        "feature", feature_plane.health_snapshot, feature_plane.stage_events
                    ),
                    ControlPlaneStageAdapter(
                        "tracking", control_plane.health_snapshot, control_plane.stage_events
                    ),
                ]
            )
            self.store.save_report("control_plane_report", hub.generate_report().to_dict())
            feature_plane.close()
        return diags

    # ------------------------------------------------------------------
    # Finalization
    # ------------------------------------------------------------------

    def finalize_run(self, trajectory_name: str = "estimated") -> SLAMRunResult:
        """Persist every artifact (the reference's names and payloads)."""
        traj_path = self.store.save_trajectory(trajectory_name, self.trajectory)
        arrays = self.trajectory.as_arrays()
        metrics = {
            "num_frames": self._frame_count,
            "num_keyframes": len(self.keyframes),
            "num_failures": self._failure_count,
            "num_relocalizations": self._reloc_count,
            **summarize_trajectory(arrays["poses"]),
        }
        metrics_path = self.store.save_metrics("run_metrics", metrics)
        diag_path = self.store.save_frame_diagnostics(
            "frame_diagnostics", [d.to_dict() for d in self.diagnostics]
        )
        telem_path = self.store.save_telemetry("events", self.telemetry.events())
        summary_path = None
        try:
            summary = summarize_telemetry_streaming(telem_path)
            summary_path = self.store.save_report("telemetry_summary", summary)
        except Exception as exc:  # the summary is optional; the run's artifacts stand
            logger.warning("telemetry summary failed", extra={"error": str(exc)})
        map_paths = None
        if self.config.persist_map_snapshot and len(self.keyframes) >= 2:
            try:
                if self._map_snapshot is None:
                    self._build_map_snapshot()
                paths = self.store.map_paths("map_snapshot")
                save_map_snapshot(self._map_snapshot, paths["arrays"], paths["metadata"])
                map_paths = paths
            except ValueError as exc:  # too little map for a vocabulary; device errors propagate
                logger.warning("map snapshot persist failed", extra={"error": str(exc)})
        return SLAMRunResult(
            run_dir=self.run_dir,
            trajectory_path=traj_path,
            metrics_path=metrics_path,
            diagnostics_path=diag_path,
            telemetry_path=telem_path,
            telemetry_summary_path=summary_path,
            map_snapshot_paths=map_paths,
            num_frames=self._frame_count,
            num_keyframes=len(self.keyframes),
            num_failures=self._failure_count,
            num_relocalizations=self._reloc_count,
        )
