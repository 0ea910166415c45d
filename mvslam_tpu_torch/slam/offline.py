"""Offline full-demo entry point: tracking + loop closure + pose-graph
correction + evaluation.

Port of ``mvslam_tpu/slam/offline.py``: the complete demo loop, per-frame
pose tracking with fallbacks, dynamic-object masking by frame differencing,
BoW loop detection with geometric verification and inlier-ratio gating,
loop-scale estimation, pose-graph optimisation on accepted loops, keyframe
+ local BA integration, and ATE/RPE against ground truth. Input: a KITTI
sequence dir, a KITTI-raw drive, a TUM sequence, an image directory, or a
video file (cv2 gated).

The compute path is the fused tracking step; this module owns the *offline
orchestration*: loop topology and corrections are host logic.
``run_visual_slam(config, device="cuda")`` and ``--device`` on the command
line carry the device: tracking, window BA, BoW, loop geometry, the
pose-graph solves and relocalization all run there; on the CPU the loop
geometry's matching runs in the native library's C++ matcher (equal bit
for bit). ``enable_animation``
(``--animate``) feeds every frame's pose, the corrected keyframe chain and
the loop edges to ``viz.path_animator.VehiclePathLiveAnimator``, which
draws only where matplotlib is installed.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from mvslam_tpu_torch.backend.keyframes import KeyframeConfig
from mvslam_tpu_torch.backend.pose_graph import PoseGraph3D
from mvslam_tpu_torch.backend.solvers import SolverConfig
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.core.telemetry import device_span, timed_event
from mvslam_tpu_torch.geometry.epipolar import decompose_essential, triangulate_normalized
from mvslam_tpu_torch.geometry.projection import make_K_from_fov, normalize_pixels
from mvslam_tpu_torch.loopclosure.bow import BoWConfig, BoWDatabase
from mvslam_tpu_torch.ops.brief import descriptor_words
from mvslam_tpu_torch.ops.hamming import (
    MatchConfig,
    MatchResult,
    gather_matched_points,
    matcher_for,
    select_matches,
)
from mvslam_tpu_torch.ops.ransac import RansacConfig, ransac_essential
from mvslam_tpu_torch.slam.api import SLAMSystem, SLAMSystemConfig

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class SLAMRunConfig:
    """Same fields and defaults as the reference's run config."""

    input_path: Path
    input_kind: str = "kitti"  # "kitti" | "kitti_raw" | "tum" | "images" | "video"
    sequence: str = "00"
    # KITTI-raw drive selection (input_kind == "kitti_raw")
    kitti_date: str = ""
    kitti_drive: str = ""
    kitti_camera: str = "image_00"
    max_frames: Optional[int] = None
    run_id: str = "offline_slam"
    output_root: Path = Path("runs")
    seed: int = 0
    # Loop closure
    enable_loop_closure: bool = True
    loop_similarity_threshold: float = 0.75
    loop_min_frame_gap: int = 30
    # > 0: device-resident BoW histogram index of this capacity
    # (loopclosure.device_index) instead of host ranking.
    device_bow_capacity: int = 0
    loop_min_inliers: int = 30
    loop_min_inlier_ratio: float = 0.4
    # Dynamic-object masking (frame differencing)
    enable_dynamic_masking: bool = False
    dynamic_diff_threshold: float = 40.0
    # Local BA over the keyframe window, on by default as in SLAMSystemConfig.
    enable_local_ba: bool = True
    # Pose source: "features" or "flow_first" (LK tracks with matching
    # fallback)
    pose_source: str = "features"
    # Windowed device dispatch: frames per tracking call (and calls per
    # dispatch). Per-frame RNG folds global frame ids so the trajectory is
    # identical at any window shape (slam/api.py run_sequence). flow_first
    # forces window=1 (the LK chain is pairwise-sequential).
    window: int = 8
    windows_per_dispatch: int = 1
    # Evaluation
    ground_truth_path: Optional[Path] = None
    # Animation
    enable_animation: bool = False


def mask_dynamic_regions(frame: np.ndarray, prev: Optional[np.ndarray], threshold: float) -> np.ndarray:
    """Suppress fast-changing pixels (moving objects) by frame differencing."""
    if prev is None or prev.shape != frame.shape:
        return frame
    diff = np.abs(frame.astype(np.float32) - prev.astype(np.float32))
    masked = frame.astype(np.float32).copy()
    masked[diff > threshold] = 0.0
    return masked


def _load_frames(config: SLAMRunConfig):
    """The input's intrinsics and its opener: ``(open_packets, K)``, where
    ``open_packets(recorder)`` starts the frame stream; a reader's loader
    records its ``frame_decode`` spans on ``recorder`` (the ``video`` kind,
    decoded on the caller's thread, records none)."""
    if config.input_kind == "kitti":
        from mvslam_tpu_torch.data.kitti import KittiSequence

        seq = KittiSequence(config.input_path, config.sequence)
        return (lambda recorder: seq.iter_frames(config.max_frames, recorder=recorder)), seq.camera_intrinsics()
    if config.input_kind == "kitti_raw":
        from mvslam_tpu_torch.data.kitti import KittiRawSession

        session = KittiRawSession(
            base_dir=config.input_path,
            date=config.kitti_date,
            drive=config.kitti_drive,
            camera=config.kitti_camera,
        )
        return (
            lambda recorder: session.iter_frames(config.max_frames, recorder=recorder)
        ), session.camera_intrinsics()
    if config.input_kind == "tum":
        from mvslam_tpu_torch.data.tum import TumSequence

        seq = TumSequence(config.input_path)
        return (lambda recorder: seq.iter_frames(config.max_frames, recorder=recorder)), seq.camera_intrinsics()
    if config.input_kind == "images":
        from mvslam_tpu_torch.runtime.frame_stream import FrameStream, _default_read_fn

        paths = sorted(Path(config.input_path).glob("*.png")) + sorted(
            Path(config.input_path).glob("*.jpg")
        )
        if config.max_frames:
            paths = paths[: config.max_frames]
        first = _default_read_fn(paths[0]) if paths else None
        h, w = (first.shape if first is not None else (370, 1226))
        # Host intrinsics for the run config: built on the CPU on purpose.
        return (lambda recorder: iter(FrameStream(paths, recorder=recorder))), make_K_from_fov(w, h, device="cpu").numpy()
    if config.input_kind == "video":
        import cv2

        from mvslam_tpu_torch.runtime.frame_stream import FramePacket

        cap = cv2.VideoCapture(str(config.input_path))
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

        def gen():
            index = 0
            while True:
                okay, frame = cap.read()
                if not okay or (config.max_frames and index >= config.max_frames):
                    break
                gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
                yield FramePacket(index=index, timestamp=index / 30.0, frame=gray)
                index += 1
            cap.release()

        return (lambda recorder: gen()), make_K_from_fov(w, h, device="cpu").numpy()
    raise ValueError(f"unknown input kind {config.input_kind!r}")


def _put(system, arr, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=system.device)


def _put_keyframe(system, kf):
    """(keypoints f32, descriptor words int32, valid bool) of a keyframe on
    the system's device."""
    return (
        _put(system, kf.keypoints, torch.float32),
        descriptor_words(kf.descriptors, system.device),
        _put(system, np.asarray(kf.valid, bool)),
    )


def _scale_from_rows(loop, chain, kf_a, kf_a_next):
    """Sim3-style loop-edge scale via structure transfer (host math).

    kf_a's features are triangulated twice by :func:`_loop_geometry`:
    against the odometry-chain neighbour (baseline known in chain units)
    and against the loop candidate (unit baseline); the loop baseline in
    chain units is the median depth ratio over features shared by both
    matchings.

    ``loop``/``chain`` are :func:`_unpack_loop_row` dicts. Returns None
    when there is no usable overlap (caller falls back).
    """
    # The chain pair's own RANSAC gates (≥ 15 raw matches and ≥ 15 inliers
    # with ≥ 8 valid pairs).
    if chain["num_valid"] < 15 or chain["num_inliers"] < 15 or chain["num_valid"] < 8:
        return None
    chain_base = float(np.linalg.norm(kf_a_next.pose[:3, 3] - kf_a.pose[:3, 3]))
    if chain_base < 1e-9:
        return None
    z_chain = chain["depths"] * chain_base  # depths of kf_a features, chain units
    ok_chain = chain["ok"] & (chain["depths"] > 1e-6)
    # Outlier correspondences still triangulate to arbitrary finite
    # positive depths under the loop (R, t); the row mask already carries
    # the RANSAC inlier gate, keeping bogus ratios out of the median.
    ok_loop = loop["ok"] & (loop["depths"] > 1e-6)

    depth_by_feature = {
        int(f): z_chain[i] for i, f in enumerate(chain["idx_a"]) if ok_chain[i]
    }
    ratios = [
        depth_by_feature[int(f)] / loop["depths"][i]
        for i, f in enumerate(loop["idx_a"])
        if ok_loop[i] and int(f) in depth_by_feature
    ]
    if len(ratios) < 8:
        return None
    return float(np.median(ratios))


_LOOP_GEOM_M = 256  # max matches per loop pair
_LOOP_THRESHOLD_PX = 2.0  # loop RANSAC's Sampson threshold
_LOOP_WEIGHT = 5.0  # the loop edge's weight in the pose graph


def _loop_pair_post(base_key, salt, idx, dist, second, ok, kpA, kpB, K, thresh):
    """Post-match loop geometry for ONE pair: select → normalise →
    essential RANSAC → decompose → triangulate → pack one row."""
    sel = select_matches(MatchResult(idx, dist, second, ok), max_matches=_LOOP_GEOM_M)
    p1, p2 = gather_matched_points(kpA, kpB, sel)
    n1 = normalize_pixels(p1, K)
    n2 = normalize_pixels(p2, K)
    r = ransac_essential(
        prng.fold_in(base_key, salt), n1, n2, sel.valid,
        RansacConfig(num_hypotheses=256, min_inliers=0),
        threshold=thresh,
    )
    w = r.inliers.to(torch.float32)
    R, t, _ = decompose_essential(r.model, n1, n2, weights=w)
    X = triangulate_normalized(R, t, n1, n2)
    head = torch.cat(
        [
            torch.stack(
                [
                    sel.num_valid.to(torch.float32),
                    r.num_inliers.to(torch.float32),
                    r.inlier_ratio,
                    torch.zeros((), dtype=torch.float32, device=K.device),
                ]
            ),
            R.reshape(9),
            t,
        ]
    )
    mask = (sel.valid & r.inliers).to(torch.float32)
    return torch.cat([head, X[:, 2], sel.pairs[:, 0].to(torch.float32), mask])


def _loop_geometry(system, kf_a, kf_bs, salts):
    """Loop geometry of kf_a against a stack of counterpart keyframes, on
    the system's device, with ONE packed fetch.

    Runs match → select → normalise → essential RANSAC → decompose →
    triangulate for each pair (the loop pair and the odometry
    chain-neighbour pair) and packs everything the host logic needs into
    one (P, 16+3M) f32 tensor. The pairs are computed one after the other
    at the unfused shapes, not batched: per-pair numerics then do not
    depend on how many pairs ride along (the reference found a batched
    variant shifting the loop-edge poses).

    Row layout: [num_valid, num_inliers, inlier_ratio, 0, R.flat (9),
    t (3), depths (M), pair_a_idx (M), valid&inlier mask (M)].
    RANSAC keys fold the per-pair ``salts`` into the loop_closure
    component key. ``min_inliers`` gates sit on the host (they only affect
    the success flag, never the model). On a CUDA device the launches are
    the span ``loop_geometry.device``.
    """
    match = matcher_for(system.device)
    K = _put(system, system.K, torch.float32)
    base_key = system.registry.key_for("loop_closure", system.device)
    thresh = _LOOP_THRESHOLD_PX / float(system.K[0, 0])
    with device_span(system.telemetry, "loop_geometry", system.device):
        kpA, descA, validA = _put_keyframe(system, kf_a)
        rows = []
        for salt, kf_b in zip(salts, kf_bs):
            kpB, descB, validB = _put_keyframe(system, kf_b)
            res = match(descA, validA, descB, validB, MatchConfig(cross_check=True))
            rows.append(
                _loop_pair_post(
                    base_key, int(salt), res.indices, res.distances, res.second_distances,
                    res.valid, kpA, kpB, K, thresh,
                )
            )
        packed = torch.stack(rows)
    return packed.cpu().numpy()  # the single fetch


def _unpack_loop_row(row):
    M = _LOOP_GEOM_M
    return {
        "num_valid": int(row[0]),
        "num_inliers": int(row[1]),
        "ratio": float(row[2]),
        "R": np.asarray(row[4:13], np.float64).reshape(3, 3),
        "t": np.asarray(row[13:16], np.float64),
        "depths": row[16 : 16 + M],
        "idx_a": row[16 + M : 16 + 2 * M].astype(np.int64),
        "ok": row[16 + 2 * M :] > 0.5,  # sel.valid & ransac inliers
    }


def _loop_gate(loop, config: SLAMRunConfig) -> Optional[str]:
    """The gate that rejects a loop row, None where it passes them all; in
    the unfused path's order: enough raw matches (``"matches"``), RANSAC
    success (count ≥ min_inliers and ≥ 8 valid pairs: ``"inliers"``),
    inlier ratio (``"ratio"``)."""
    if loop["num_valid"] < config.loop_min_inliers:
        return "matches"
    if loop["num_inliers"] < config.loop_min_inliers or loop["num_valid"] < 8:
        return "inliers"
    if loop["ratio"] < config.loop_min_inlier_ratio:
        return "ratio"
    return None


def _verify_loop(system, kf_a, kf_b, config: SLAMRunConfig, kf_a_next=None, record=None):
    """Geometric loop verification: match + essential RANSAC between two
    keyframes; returns (T_a_b relative SE3, inliers, ratio) or None.

    The loop pair and the chain-neighbour pair (for the structure-transfer
    scale) are computed by one :func:`_loop_geometry` call; this function
    is the host gating/assembly. The span ``loop_geometry`` carries the
    query, the candidate, whether the loop was accepted and the gate that
    rejected it. ``record``, a dict, takes the loop row's counts, its
    pair's feature indices and inlier mask, the gate, and for an accepted
    loop the edge: R and unit t of the pair, the scale, ``rel`` and the
    threshold in pixels.
    """
    salts = [int(kf_b.frame_id), int(kf_a.frame_id) * 2 + 1]
    pair_bs = [kf_b, kf_a_next if kf_a_next is not None else kf_b]
    ids = {"query": int(kf_b.frame_id), "candidate": int(kf_a.frame_id)}
    with timed_event(system.telemetry, "loop_geometry", metadata=ids) as meta:
        rows = _loop_geometry(system, kf_a, pair_bs, salts)
        loop = _unpack_loop_row(rows[0])
        gate = _loop_gate(loop, config)
        meta.update(accepted=gate is None, gate=gate)
    if record is not None:
        record.update(
            gate=gate, num_valid=loop["num_valid"], num_inliers=loop["num_inliers"], inlier_ratio=loop["ratio"],
            idx_a=loop["idx_a"], ok=loop["ok"],
        )
    if gate is not None:
        return None
    inliers = loop["num_inliers"]
    ratio = loop["ratio"]
    R = loop["R"]
    t = loop["t"]
    # Loop-edge scale: structure transfer through kf_a's chain neighbour
    # when possible (a true revisit yields a near-zero baseline, which the
    # chain-distance heuristic below cannot see), else the odometry
    # chain's distance.
    chain_dist = float(np.linalg.norm(kf_b.pose[:3, 3] - kf_a.pose[:3, 3]))
    scale = None
    if kf_a_next is not None:
        scale = _scale_from_rows(loop, _unpack_loop_row(rows[1]), kf_a, kf_a_next)
    if scale is None:
        scale = max(chain_dist, 1e-6) if chain_dist < 1.0 else 1.0
    else:
        # A loop baseline beyond the chain estimate is unphysical drift
        # amplification: cap it.
        scale = float(np.clip(scale, 0.0, max(chain_dist, 1.0)))
    rel = np.eye(4)
    rel[:3, :3] = R.T
    rel[:3, 3] = -R.T @ (t * scale)
    if record is not None:
        record.update(R=R, t=t, scale=scale, rel=rel, threshold_px=_LOOP_THRESHOLD_PX)
    return rel, inliers, ratio


def _propagate_correction(system, corrected) -> None:
    """Carry corrected keyframe poses into the recorded per-frame
    trajectory: each keyframe's rigid delta applies to its span of frames
    (loop closure must move the final estimate, not just the keyframe
    chain). Then the keyframes and the system's current pose take the
    corrected values."""
    kfs = system.keyframes.keyframes
    traj = system.trajectory
    fid_to_idx = {f: i for i, f in enumerate(traj.frame_ids)}
    for k, kf_obj in enumerate(kfs):
        start = fid_to_idx.get(kf_obj.frame_id)
        if start is None:
            continue
        delta = corrected[k] @ np.linalg.inv(kf_obj.pose)
        end = (
            fid_to_idx.get(kfs[k + 1].frame_id, len(traj.poses))
            if k + 1 < len(kfs)
            else len(traj.poses)
        )
        for idx in range(start, end):
            traj.poses[idx] = delta @ traj.poses[idx]
    for k, kf_obj in enumerate(kfs):
        kf_obj.pose = corrected[k]
    system._pose = corrected[-1].copy()


def _correct_keyframe_chain(system, cand_frame_id: int, query_frame_id: int, rel, record=None) -> None:
    """Pose-graph correction over the keyframe chain for one accepted loop
    edge ``rel`` (candidate -> query), propagated into the trajectory.

    The span ``loop_pose_graph`` carries the graph's nodes and edges and
    the iterations the solver ran; on a CUDA device the solve is the span
    ``pose_graph.device``. ``record``, a dict, takes the loop edge's nodes
    and weight and the keyframe poses that went into and came out of the
    solve."""
    kfs = system.keyframes.keyframes
    before = [k.pose for k in kfs]
    with timed_event(system.telemetry, "loop_pose_graph", metadata={"nodes": len(kfs)}) as meta:
        graph = PoseGraph3D.from_pose_matrices(before, device=system.device)
        id_to_node = {k.frame_id: idx for idx, k in enumerate(kfs)}
        nodes = (id_to_node[cand_frame_id], id_to_node[query_frame_id])
        graph.add_loop_matrix(*nodes, rel, weight=_LOOP_WEIGHT)
        with device_span(system.telemetry, "pose_graph", system.device):
            result = graph.optimize(SolverConfig(max_iterations=15, damping=1e-4))
        corrected = graph.poses()
        meta.update(edges=graph.num_edges, iterations=result.iterations)
    if record is not None:
        record.update(
            nodes=nodes, weight=_LOOP_WEIGHT, iterations=result.iterations,
            poses_before=np.stack(before), poses_after=np.array(corrected, dtype=np.float64),
        )
    _propagate_correction(system, corrected)


class OfflineSummary(dict):
    """What :func:`run_visual_slam` returns: the items of
    ``offline_summary.json`` and ``run_dir``, with what stays in memory as
    attributes: ``loop_records`` (per detected loop: query, candidate, BoW
    score, the loop row's counts, its pair's feature indices and inlier
    mask, the rejecting gate or None; per accepted loop also its edge and
    the keyframe poses into and out of its solve), ``odometry`` (per frame,
    its pose relative to the frame before as the tracking step chained it,
    before any loop correction) and ``system``, the :class:`SLAMSystem`
    (diagnostics, trajectory, keyframes, telemetry)."""

    def __init__(self, items, loop_records, odometry, system):
        super().__init__(items)
        self.loop_records = loop_records
        self.odometry = odometry
        self.system = system


def run_visual_slam(
    config: SLAMRunConfig,
    device="cuda",
    source: Optional[Callable[[Any], Iterable[Any]]] = None,
) -> OfflineSummary:
    """Track, close loops, correct the pose graph and evaluate, on ``device``.

    ``source(recorder)``, where given, yields the frame packets in place of
    the configuration's reader (K still comes from the configuration's
    calibration); ``recorder`` is the run's telemetry, for the source's own
    spans, as the readers' ``frame_decode``. Spans: ``run_visual_slam``
    around the tracking pass, with its frames and the loops detected and
    accepted; ``bow_keyframe`` per keyframe; ``loop_geometry`` and
    ``loop_pose_graph`` per detected and accepted loop. Returns an
    :class:`OfflineSummary`.
    """
    open_packets, K = _load_frames(config)
    system = SLAMSystem(
        SLAMSystemConfig(
            run_id=config.run_id,
            output_root=config.output_root,
            seed=config.seed,
            fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
            keyframe=KeyframeConfig(min_translation=0.05),
            enable_local_ba=config.enable_local_ba,
            pose_source=config.pose_source,
        ),
        device=device,
    )
    packets = (source or open_packets)(system.telemetry)
    bow = BoWDatabase(
        BoWConfig(
            vocab_size=64,
            similarity_threshold=config.loop_similarity_threshold,
            min_frame_gap=config.loop_min_frame_gap,
            min_train_descriptors_factor=5,
            device_index_capacity=config.device_bow_capacity,
        ),
        key=system.registry.key_for("bow", system.device),
        device=system.device,
    )

    animator = None
    if config.enable_animation:
        from mvslam_tpu_torch.viz.path_animator import VehiclePathLiveAnimator

        animator = VehiclePathLiveAnimator()
        animator.start()

    loops_detected: List[Dict[str, Any]] = []
    loops_accepted: List[Dict[str, Any]] = []
    loop_records: List[Dict[str, Any]] = []
    odometry: Dict[int, np.ndarray] = {}
    chained = system.pose  # the pose the next frame's step chains onto
    seen_keyframes = 0

    def frame_pairs():
        """(frame, timestamp) stream with optional dynamic masking."""
        prev_frame: Optional[np.ndarray] = None
        for packet in packets:
            frame = packet.frame
            if config.enable_dynamic_masking:
                frame = mask_dynamic_regions(frame, prev_frame, config.dynamic_diff_threshold)
                prev_frame = np.asarray(packet.frame)
            yield frame, packet.timestamp

    def on_frame(diag):
        """Per-frame host consumer: animation + loop closure.

        Runs after the engine's own host bookkeeping (keyframes,
        relocalization) for that frame; in windowed mode it lags the
        device by one window, like all host logic.
        """
        nonlocal seen_keyframes, chained
        odometry[diag.frame_id] = np.linalg.inv(chained) @ system.pose
        if animator is not None:
            animator.update(system.pose)
        if config.enable_loop_closure and len(system.keyframes) > seen_keyframes:
            # New keyframe → feed BoW, query for loops (host logic).
            seen_keyframes = len(system.keyframes)
            _handle_keyframe(system.keyframes.keyframes[-1])
        chained = system.pose

    def _handle_keyframe(kf):
        """Per-keyframe loop-closure logic (BoW + verification + pose graph)."""
        # ONE histogram computation per keyframe (query-then-add fused);
        # detect_loop + add_frame would compute it twice.
        with timed_event(system.telemetry, "bow_keyframe", metadata={"frame_id": int(kf.frame_id)}):
            hit = bow.process_keyframe(kf.frame_id, kf.descriptors, kf.valid)
        if hit is None:
            return
        cand_frame_id, score = hit
        cand = next(
            (k for k in system.keyframes.keyframes if k.frame_id == cand_frame_id), None
        )
        if cand is None:
            return
        loops_detected.append(
            {"query": kf.frame_id, "candidate": cand_frame_id, "bow_score": score}
        )
        record = dict(loops_detected[-1])
        loop_records.append(record)
        logger.info(
            "loop candidate", extra={"query": kf.frame_id, "candidate": cand_frame_id}
        )
        cand_idx = next(
            i for i, k in enumerate(system.keyframes.keyframes)
            if k.frame_id == cand_frame_id
        )
        neighbours = system.keyframes.keyframes
        cand_next = (
            neighbours[cand_idx + 1] if cand_idx + 1 < len(neighbours) else None
        )
        verified = _verify_loop(system, cand, kf, config, kf_a_next=cand_next, record=record)
        if verified is None:
            return
        rel, inliers, ratio = verified
        loops_accepted.append(
            {
                "query": kf.frame_id,
                "candidate": cand_frame_id,
                "inliers": inliers,
                "inlier_ratio": ratio,
            }
        )
        _correct_keyframe_chain(system, cand_frame_id, kf.frame_id, rel, record=record)
        if animator is not None:
            kfs = system.keyframes.keyframes
            node = {k.frame_id: i for i, k in enumerate(kfs)}
            animator.set_optimized([(k.pose[0, 3], k.pose[2, 3]) for k in kfs])
            animator.add_loop_edge(node[cand_frame_id], node[kf.frame_id])
        logger.info(
            "loop accepted",
            extra={"query": kf.frame_id, "candidate": cand_frame_id, "inliers": inliers},
        )

    # Windowed device dispatch (one tracking call + one scalar pull per
    # window) with the per-frame host logic, including the loop-closure
    # hook above, running as the engine's on_frame callback.
    window = 1 if config.pose_source == "flow_first" else max(1, config.window)
    try:
        with timed_event(system.telemetry, "run_visual_slam") as meta:
            diags = system._run_windowed(frame_pairs(), window, config.windows_per_dispatch, on_frame)
            meta.update(frames=len(diags), loops_detected=len(loops_detected), loops_accepted=len(loops_accepted))
    finally:
        if animator is not None:
            animator.stop()

    result = system.finalize_run()
    summary = OfflineSummary({
        "run_dir": str(result.run_dir),
        "frames": result.num_frames,
        "keyframes": result.num_keyframes,
        "failures": result.num_failures,
        "loops_detected": loops_detected,
        "loops_accepted": loops_accepted,
    }, loop_records, odometry, system)
    if config.ground_truth_path is not None:
        from mvslam_tpu_torch.eval.trajectory import (
            compute_additional_metrics,
            load_trajectory_file,
            positions_from_poses,
        )

        gt = load_trajectory_file(config.ground_truth_path, "kitti_odom")
        est = positions_from_poses(np.stack(system.trajectory.poses))
        summary["metrics"] = compute_additional_metrics(est, gt)
    elif config.input_kind == "kitti_raw":
        # OXTS ground truth: ATE/RPE in the ground plane, camera (x, z)
        # vs OXTS (east, north), Sim(2)-aligned (monocular scale is free).
        from mvslam_tpu_torch.data.kitti import KittiRawSession
        from mvslam_tpu_torch.eval.trajectory import compute_additional_metrics

        session = KittiRawSession(
            base_dir=config.input_path,
            date=config.kitti_date,
            drive=config.kitti_drive,
            camera=config.kitti_camera,
        )
        gt_pos = session.oxts_positions()
        est = np.stack(system.trajectory.poses)[:, :3, 3]
        n = min(len(gt_pos), len(est))
        summary["metrics"] = compute_additional_metrics(
            est[:n][:, [0, 2]], gt_pos[:n, :2]
        )
        summary["ground_truth"] = "oxts"
    # Persist WITHOUT run_dir: the two-run determinism contract (every
    # artifact bitwise equal for identical config+seed) must hold across
    # different output roots, and both the absolute path and the
    # timestamped directory name can never match between runs. The file
    # lives inside the run dir, so the field carries no information there;
    # the returned in-memory summary keeps it for callers.
    persisted = {k: v for k, v in summary.items() if k != "run_dir"}
    (result.run_dir / "offline_summary.json").write_text(
        json.dumps(persisted, indent=2, sort_keys=True, default=str)
    )
    return summary


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Offline visual SLAM demo (PyTorch)")
    parser.add_argument("--input", type=Path, required=True)
    parser.add_argument(
        "--kind", choices=["kitti", "kitti_raw", "tum", "images", "video"], default="kitti"
    )
    parser.add_argument("--sequence", default="00")
    parser.add_argument("--date", default="", help="KITTI-raw drive date (e.g. 2011_09_26)")
    parser.add_argument("--drive", default="", help="KITTI-raw drive id (e.g. 0001)")
    parser.add_argument("--camera", default="image_00", help="KITTI-raw camera dir")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--output-root", type=Path, default=Path("runs"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="torch device of every stage (cuda, cpu)")
    parser.add_argument("--no-loop-closure", action="store_true")
    parser.add_argument("--loop-threshold", type=float, default=0.75)
    parser.add_argument("--loop-min-gap", type=int, default=30)
    parser.add_argument("--loop-min-inliers", type=int, default=30)
    parser.add_argument(
        "--device-bow-capacity", type=int, default=0,
        help="> 0: rank loop candidates in a device-resident BoW index of this capacity",
    )
    parser.add_argument("--dynamic-masking", action="store_true")
    parser.add_argument(
        "--local-ba", dest="local_ba", action="store_true", default=True,
        help="window BA on keyframe insertion (default ON, reference parity)",
    )
    parser.add_argument("--no-local-ba", dest="local_ba", action="store_false")
    parser.add_argument(
        "--pose-source", choices=["features", "flow_first"], default="features",
        help="flow_first: pyramidal LK pose with feature-matching fallback",
    )
    parser.add_argument("--ground-truth", type=Path, default=None)
    parser.add_argument("--animate", action="store_true")
    parser.add_argument("--window", type=int, default=8, help="frames per tracking call")
    parser.add_argument(
        "--windows-per-dispatch", type=int, default=1,
        help="windows run inside one dispatch (throughput mode)",
    )
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    summary = run_visual_slam(
        SLAMRunConfig(
            input_path=args.input,
            input_kind=args.kind,
            sequence=args.sequence,
            kitti_date=args.date,
            kitti_drive=args.drive,
            kitti_camera=args.camera,
            max_frames=args.max_frames,
            output_root=args.output_root,
            seed=args.seed,
            enable_loop_closure=not args.no_loop_closure,
            loop_similarity_threshold=args.loop_threshold,
            loop_min_frame_gap=args.loop_min_gap,
            device_bow_capacity=args.device_bow_capacity,
            loop_min_inliers=args.loop_min_inliers,
            enable_dynamic_masking=args.dynamic_masking,
            enable_local_ba=args.local_ba,
            pose_source=args.pose_source,
            ground_truth_path=args.ground_truth,
            enable_animation=args.animate,
            window=args.window,
            windows_per_dispatch=args.windows_per_dispatch,
        ),
        device=args.device,
    )
    print(
        json.dumps(
            {
                "frames": summary["frames"],
                "keyframes": summary["keyframes"],
                "loops_accepted": len(summary["loops_accepted"]),
                "run_dir": summary["run_dir"],
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
