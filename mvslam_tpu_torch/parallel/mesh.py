"""Device-mesh scaling: data-parallel tracking, hypothesis-sharded RANSAC,
observation-sharded bundle adjustment and factor-sharded pose graphs.

Port of ``mvslam_tpu/parallel/mesh.py``. The reference's mesh is
single-controller (one process drives every device); so is the port's
(:class:`~mvslam_tpu_torch.core.sharding.Mesh`, a tuple of device slots):

- **Data parallelism over frames**: a window of frames, or a batch of frame
  pairs, is split into the mesh's blocks and each slot runs the tracking
  step on its block. The one-frame pair shift crosses blocks as one
  FeatureSet handed from slot s−1 to slot s (the reference's boundary
  collective-permute).
- **Hypothesis parallelism for RANSAC**: the K hypotheses are drawn from
  the one global key, then each slot solves and scores its block against
  the replicated correspondences; the winner is picked across slots by
  (votes, hypothesis index).
- **Observation and factor parallelism** for the back end: each slot
  linearizes its block and assembles partial normal equations, added in
  slot order on slot 0's device, where the small solve runs.

Slots run one after another from the Python thread; launches are
asynchronous, so slots on different cards overlap. A mesh may name one
device in several slots (``Mesh(["cpu"] * 8, ("data",))`` is the
counterpart of the reference tests' eight virtual CPU devices): the same
code then splits one device's work as that mesh would, which is how its
contracts are checked on one card or on the CPU.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import torch

from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.core.sharding import Mesh, NamedSharding, blocks
from mvslam_tpu_torch.frontend.feature_pipeline import FeaturePipelineConfig, FeatureSet
from mvslam_tpu_torch.frontend.pose_estimator import RobustPoseEstimatorConfig
from mvslam_tpu_torch.ops.ransac import RansacConfig, RansacResult, ransac_essential
from mvslam_tpu_torch.slam.tracking import (
    TrackResult,
    _concat,
    _detect_describe,
    _track_pairs,
    track_superwindow_chunked,
)

logger = logging.getLogger(__name__)


def make_mesh(n_devices: Optional[int] = None, axis: str = "data") -> Mesh:
    """One-axis mesh over the first ``n_devices`` visible CUDA devices (all
    of them by default). Logical meshes (a device in several slots, or the
    CPU) are built directly: ``Mesh(["cuda:0"] * 4, ("data",))``."""
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("make_mesh: no CUDA device is visible; build Mesh([...], ('data',)) for the CPU")
    n = count if n_devices is None else int(n_devices)
    if not 0 < n <= count:
        raise ValueError(f"make_mesh: {n} devices asked for, {count} visible")
    return Mesh([torch.device("cuda", i) for i in range(n)], (axis,))


def batched_track_pairs(
    mesh: Mesh,
    frames_prev: torch.Tensor,
    frames_next: torch.Tensor,
    K: torch.Tensor,
    feature_config: FeaturePipelineConfig,
    pose_config: RobustPoseEstimatorConfig,
    seed: int = 0,
) -> Tuple[FeatureSet, TrackResult]:
    """Track B frame pairs data-parallel over the mesh.

    frames_prev/frames_next: (B, H, W); B must divide by the mesh size.
    Pair i draws its hypotheses from ``fold_in(key(seed), i)`` (its global
    index), so features and matches are bit-equal on any mesh size. Returns
    the next frames' FeatureSet and the TrackResult, leading axis B, on
    slot 0's device. Meshed runs pin the RANSAC reduction order
    (``mesh_invariant=True``).
    """
    pose_config = dataclasses.replace(pose_config, mesh_invariant=True)
    feats_parts, track_parts = [], []
    for (lo, hi), dev in zip(blocks(frames_prev.shape[0], mesh.size, "batch"), mesh.devices):
        prev = _detect_describe(frames_prev[lo:hi].to(dev), feature_config)
        nxt = _detect_describe(frames_next[lo:hi].to(dev), feature_config)
        keys = prng.fold_in(prng.key(seed, dev), torch.arange(lo, hi, device=dev))
        track_parts.append(_track_pairs(keys, prev, nxt, K.to(dev), feature_config, pose_config))
        feats_parts.append(nxt)
    return _concat(feats_parts, mesh.devices[0]), _concat(track_parts, mesh.devices[0])


def sharded_ransac_essential(
    mesh: Mesh,
    key: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    config: RansacConfig = RansacConfig(threshold=2e-3),
) -> RansacResult:
    """Essential-matrix RANSAC with the hypothesis solve and scoring split
    over the mesh.

    **Mesh-invariant determinism**: the K hypotheses are drawn from the one
    global ``key`` exactly as in the unsharded
    :func:`~mvslam_tpu_torch.ops.ransac.ransac_essential`; each slot solves
    and scores its block through the order-pinned forms, and the winner is
    the lexicographic pick (most votes, then lowest hypothesis index). The
    returned model and inliers are **bit-equal on any mesh size**, and equal
    to the unsharded call with ``mesh_invariant=True`` (this wrapper forces
    it; an unsharded run compared with it must set it too). The refit runs
    on the inputs' device.
    """
    if config.num_hypotheses % mesh.size:
        raise ValueError(f"num_hypotheses ({config.num_hypotheses}) must divide by mesh size {mesh.size}")
    config = dataclasses.replace(config, mesh_invariant=True)
    return ransac_essential(
        key, pts1, pts2, mask, config, hypothesis_sharding=NamedSharding(mesh, mesh.axis_names[0])
    )


def track_superwindow_meshed(
    mesh: Mesh,
    key: torch.Tensor,
    prev_features: FeatureSet,
    frames: torch.Tensor,  # (S*window, H, W)
    K: torch.Tensor,
    feature_config: FeaturePipelineConfig,
    pose_config: RobustPoseEstimatorConfig,
    window: int = 16,
    start_index=0,
):
    """The throughput path (``track_superwindow``) data-parallel over a mesh.

    Each window's frames are split over the mesh: slot s detects features
    for its contiguous block of window/size frames, its first pair takes
    slot s−1's last FeatureSet (slot 0's takes the carry), and it matches
    and estimates its pairs. The carry into the next window is the last
    slot's last frame. Feeds
    :func:`~mvslam_tpu_torch.slam.tracking.track_superwindow_chunked`.

    Determinism contract: per-pair keys fold global frame ids, never slot
    ids, and the RANSAC reduction order is pinned (``mesh_invariant=True``
    is forced; an unsharded run compared with this one must set it too).
    Detections, descriptors, ``num_matches``, ``num_features``,
    ``match_mask`` and ``use_essential`` are then bit-equal to the
    unsharded ``track_superwindow`` on any mesh size; pose entries agree
    within 1e-3 (the decompositions after RANSAC accumulate in orders the
    batch shape may change). A fixed mesh is bit-equal run to run. Returns
    the final FeatureSet and a TrackResult with leading axes
    (S, window), on slot 0's device.
    """
    if window % mesh.size:
        raise ValueError(f"window ({window}) must divide by mesh size {mesh.size}")
    pose_config = dataclasses.replace(pose_config, mesh_invariant=True)
    if frames.shape[0] % window:
        raise ValueError("frames length must be a multiple of window")
    num_windows = frames.shape[0] // window
    chunks = frames.reshape(num_windows, window, *frames.shape[1:])
    starts = [int(start_index) + window * w for w in range(num_windows)]
    return track_superwindow_chunked(
        key, prev_features, chunks, K, feature_config, pose_config, starts,
        window_sharding=NamedSharding(mesh, mesh.axis_names[0]),
    )


def run_bundle_adjustment_sharded(
    mesh: Mesh,
    poses,
    points,
    observations,
    K,
    config=None,
    max_observations: Optional[int] = None,
):
    """Windowed BA with the observation axis split over the mesh.

    The hot part of each Schur-LM iteration — the vmapped ``jacfwd``
    linearization of every reprojection residual and the segment-sum
    assembly of the block Hessians B/C/E and gradients — runs per slot on
    its block of observations; the partials are added in slot order on
    slot 0's device, where the 6W×6W Schur solve and the 3×3 point
    back-substitutions run. Results match the unsharded
    :func:`~mvslam_tpu_torch.backend.bundle_adjustment.run_bundle_adjustment`
    to float tolerance (the sums are split) and are bit-equal run to run
    for a fixed mesh.

    Any observation count takes the sharded path: the padded budget is
    rounded up to a mesh multiple here (padding rows are masked out and add
    exact zeros).
    """
    from mvslam_tpu_torch.backend.bundle_adjustment import run_bundle_adjustment

    n_dev = mesh.size
    if max_observations is None:
        O = len(observations)
        max_observations = max(64, 1 << max(O - 1, 1).bit_length())
    if max_observations % n_dev:
        rounded = max_observations + (n_dev - max_observations % n_dev)
        logger.info(
            "rounding BA observation budget to a mesh multiple",
            extra={"requested": max_observations, "rounded": rounded, "mesh": n_dev},
        )
        max_observations = rounded
    return run_bundle_adjustment(
        poses, points, observations, K, config, max_observations=max_observations,
        observation_sharding=NamedSharding(mesh, mesh.axis_names[0]),
    )


def solve_problem_sharded(mesh: Mesh, problem, config=None):
    """Pose-graph Gauss-Newton with the factor (edge) axis split over the
    mesh.

    Each slot linearizes its block of factors and assembles its partial
    JᵀWJ and JᵀWr; the partials are added in slot order on slot 0's
    device, where the (n·d)² solve runs (Cholesky or CG). Results match
    the unsharded ``backend.solvers.solve_problem`` to float tolerance and
    are bit-equal run to run for a fixed mesh. A factor count that does not
    divide by the mesh size is padded with zero-weight identity self-edges
    on node 0, which add exact zeros to the normal equations.
    """
    from mvslam_tpu_torch.backend.solvers import SolverConfig, solve_problem

    config = config or SolverConfig()
    n_dev = mesh.size
    if problem.num_factors == 0:
        return solve_problem(problem, config)
    n_pad = (-problem.num_factors) % n_dev
    if n_pad:
        d = problem.measurements.shape[1]
        problem = problem._replace(
            edges=torch.cat([problem.edges, problem.edges.new_zeros((n_pad, 2))]),
            measurements=torch.cat([problem.measurements, problem.measurements.new_zeros((n_pad, d))]),
            weights=torch.cat([problem.weights, problem.weights.new_zeros((n_pad,))]),
        )
        logger.info(
            "padded pose-graph factors to a mesh multiple",
            extra={"factors": problem.num_factors - n_pad, "padded_to": problem.num_factors},
        )
    return solve_problem(problem, config, factor_sharding=NamedSharding(mesh, mesh.axis_names[0]))

