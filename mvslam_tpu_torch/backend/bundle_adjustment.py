"""Sliding-window bundle adjustment with a Schur-complement
Levenberg-Marquardt solver.

Port of ``mvslam_tpu/backend/bundle_adjustment.py``: a window of poses
(first pose anchored, the second's translation fixed for the monocular
gauge) and 3-D points, per-observation reprojection residuals under a Huber
loss, a soft prior tying each pose to its initial value, and a conditioning
gate that returns the prior state when the Schur-reduced pose system is
ill-conditioned, the solve did not lower the cost, or the state is not
finite.

H = [[B, E], [Eᵀ, C]] with B block-diagonal over poses and C block-diagonal
3x3 over points: the solve is on S = B − E C⁻¹ Eᵀ (6W×6W), then the points
are back-substituted. The per-observation Jacobians come from one
``torch.func.vmap`` of ``jacfwd`` over rows gathered outside it; every
assembly is a deterministic segment sum over tables built on the host from
the observation indices. The LM iterations are a Python loop with
``torch.where`` masking and no host read inside; the result comes back in
one packed fetch. Observations and points are padded to power-of-two
budgets, as in the reference. ``observation_sharding`` splits the padded
observations over a mesh: each slot linearizes its block and assembles
partial normal equations with tables built over that block; the partials
are added in slot order on slot 0's device, where the Schur solve runs.

``WindowBundleAdjuster`` builds the observations from a keyframe window:
consecutive pairs are matched (cross-checked Hamming) and RANSAC-gated on
the adjuster's device (on the CPU the matching runs in the native
library's C++ matcher, equal bit for bit), the gated matches are
chained into tracks, triangulated over each track's widest span and gated
on their worst reprojection, then refined; a refinement that moves a pose
beyond a share of the keyframe spacing is rejected like a conditioning
trip.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from mvslam_tpu_torch.backend.segments import segment_sum, segment_table
from mvslam_tpu_torch.backend.solvers import _solve_pos
from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.core.sharding import NamedSharding, add_in_order, blocks
from mvslam_tpu_torch.core.telemetry import RunTelemetryRecorder, timed_event
from mvslam_tpu_torch.geometry.lie import se3_matrix, so3_exp, so3_log
from mvslam_tpu_torch.geometry.linalg import inv3x3
from mvslam_tpu_torch.geometry.projection import normalize_pixels
from mvslam_tpu_torch.ops.hamming import (
    MatchConfig,
    gather_matched_points,
    matcher_for,
    select_matches,
)
from mvslam_tpu_torch.ops.ransac import RansacConfig, ransac_essential


@dataclass(frozen=True)
class Observation:
    """One 2D observation of a 3D point from a windowed pose."""

    pose_index: int
    point_index: int
    uv: np.ndarray  # (2,)


@dataclass(frozen=True)
class BundleAdjustmentConfig:
    max_iterations: int = 10
    damping: float = 1e-4
    huber_delta_px: float = 2.0
    max_condition_number: float = 1e8
    min_singular_value: float = 1e-12
    fix_first_pose: bool = True
    fix_second_translation: bool = True  # monocular gauge (scale) fixing
    # Soft prior anchoring each pose to its initial value (px-equivalent
    # residual per unit of parameter change): keeps the solve a refinement
    # of the tracking chain along monocular BA's weak scale/depth modes.
    pose_prior_weight: float = 10.0


@dataclass
class BundleAdjustmentDiagnostics:
    initial_cost: float
    final_cost: float
    iterations: int
    converged: bool
    conditioning_tripped: bool
    condition_number: float


class BAResult(NamedTuple):
    poses: np.ndarray  # (W, 4, 4)
    points: np.ndarray  # (P, 3)
    diagnostics: BundleAdjustmentDiagnostics


class BATables(NamedTuple):
    """Segment tables of the valid observations, by pose, by point and by
    (pose, point) pair."""

    pose: torch.Tensor
    point: torch.Tensor
    pair: torch.Tensor


def ba_tables(obs_pose, obs_point, obs_mask, num_poses: int, num_points: int, device=None) -> BATables:
    """Tables for :func:`_ba_core` from the host's observation arrays."""
    obs_pose = np.asarray(obs_pose, np.int64)
    obs_point = np.asarray(obs_point, np.int64)
    return BATables(
        segment_table(obs_pose, num_poses, device, keep=obs_mask),
        segment_table(obs_point, num_points, device, keep=obs_mask),
        segment_table(obs_pose * num_points + obs_point, num_poses * num_points, device, keep=obs_mask),
    )


def _pose_params(T: torch.Tensor) -> torch.Tensor:
    """(W,4,4) world-from-camera → (W,6) [t, rvec] of camera-from-world."""
    R = T[..., :3, :3].transpose(-1, -2)
    t = -(R @ T[..., :3, 3][..., None])[..., 0]
    return torch.cat([t, so3_log(R)], dim=-1)


def _params_to_pose(p: torch.Tensor) -> torch.Tensor:
    """(W,6) camera-from-world params → (W,4,4) world-from-camera."""
    R_wc = so3_exp(p[..., 3:6]).transpose(-1, -2)
    t_wc = -(R_wc @ p[..., :3][..., None])[..., 0]
    return se3_matrix(R_wc, t_wc)


def _project(pose_param: torch.Tensor, point: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Project a world point through camera-from-world params [t, rvec]."""
    cam = so3_exp(pose_param[3:6]) @ point + pose_param[:3]
    z = torch.where(cam[2].abs() < 1e-6, torch.full_like(cam[2], 1e-6), cam[2])
    u = K[0, 0] * cam[0] / z + K[0, 2]
    v = K[1, 1] * cam[1] / z + K[1, 2]
    return torch.stack([u, v])


class ObservationBlock(NamedTuple):
    """One slot's observations (a block of the padded budget) on its device,
    with segment tables built over the block alone."""

    obs_pose: torch.Tensor
    obs_point: torch.Tensor
    obs_uv: torch.Tensor
    obs_mask: torch.Tensor
    K: torch.Tensor
    tables: BATables


def _ba_core(pose_params0, points0, obs_pose, obs_point, obs_uv, obs_mask, K, config: BundleAdjustmentConfig,
             num_poses: int, tables: BATables, shards: Optional[List[ObservationBlock]] = None):
    """The LM iterations on the inputs' device. Returns (pose params,
    points, initial cost, final cost, eig_min, eig_max), the eigenvalues
    those of the data term's reduced system at the first linearization.

    ``shards`` (default: the one block of all observations on the inputs'
    device): per-slot blocks whose linearizations, costs and partial
    normal equations are added in slot order on the inputs' device."""
    if shards is None:
        shards = [ObservationBlock(obs_pose, obs_point, obs_uv, obs_mask, K, tables)]
    W = num_poses
    P = points0.shape[0]
    dtype, device = pose_params0.dtype, pose_params0.device
    delta = torch.full((), config.huber_delta_px, dtype=dtype, device=device)  # a fill, not a host copy
    d2 = delta * delta
    free_np = np.ones((W, 6), bool)
    if config.fix_first_pose:
        free_np[0] = False
    if config.fix_second_translation and W > 1:
        free_np[1, :3] = False
    # The free coordinates of the Schur system: the conditioning check
    # decomposes exactly that sub-block.
    free_idx = torch.from_numpy(np.flatnonzero(free_np.reshape(-1))).to(device)
    pose_free = torch.as_tensor(free_np, dtype=dtype, device=device)
    free = pose_free.reshape(-1)
    prior_w2 = torch.full((), config.pose_prior_weight**2, dtype=dtype, device=device)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    eye6 = torch.eye(6, dtype=dtype, device=device)
    eyeW = torch.eye(W, dtype=dtype, device=device)

    def data_cost(pp, pts, blk: ObservationBlock):
        """Σ ρ over one block's valid observations."""
        dl, dl2 = delta.to(blk.K.device), d2.to(blk.K.device)
        r = vmap(_project, in_dims=(0, 0, None))(pp[blk.obs_pose], pts[blk.obs_point], blk.K) - blk.obs_uv
        r = torch.where(blk.obs_mask[:, None], r, torch.zeros_like(r))
        s = (r * r).sum(dim=-1)
        rho = torch.where(s <= dl2, s, 2.0 * dl * torch.sqrt(torch.maximum(s, dl2)) - dl2)
        return torch.where(blk.obs_mask, rho, torch.zeros_like(rho)).sum()

    def cost_of(pp, pts):
        data = 0.5 * add_in_order(
            [data_cost(pp.to(b.K.device), pts.to(b.K.device), b) for b in shards], device
        )
        return data + 0.5 * prior_w2 * (pose_free * (pp - pose_params0) ** 2).sum()

    def assemble(pp, pts, blk: ObservationBlock):
        """One block's linearization and partial (B, C, E, gp, gx)."""
        Kb = blk.K

        def lin_single(pose_p, point, uv, m):
            def res_fn(a, b):
                return (_project(a, b, Kb) - uv) * m

            Jp, Jx = jacfwd(res_fn, argnums=(0, 1))(pose_p, point)  # (2, 6), (2, 3)
            return res_fn(pose_p, point), Jp, Jx

        mf = blk.obs_mask.to(dtype)
        r, Jp, Jx = vmap(lin_single)(pp[blk.obs_pose], pts[blk.obs_point], blk.obs_uv, mf)
        s = (r * r).sum(dim=-1)
        dl, dl2 = delta.to(Kb.device), d2.to(Kb.device)
        w_irls = torch.where(s <= dl2, torch.ones_like(s), dl / torch.sqrt(torch.maximum(s, dl2))) * mf
        Jp_w = Jp * w_irls[:, None, None]
        Jx_w = Jx * w_irls[:, None, None]
        t = blk.tables
        return (
            segment_sum(torch.einsum("ori,orj->oij", Jp, Jp_w), t.pose),  # (W, 6, 6)
            segment_sum(torch.einsum("ori,orj->oij", Jx, Jx_w), t.point),  # (P, 3, 3)
            segment_sum(torch.einsum("ori,orj->oij", Jp, Jx_w), t.pair).reshape(W, P, 6, 3),
            segment_sum(torch.einsum("ori,or->oi", Jp_w, r), t.pose),
            segment_sum(torch.einsum("ori,or->oi", Jx_w, r), t.point),
        )

    init_cost = cost_of(pose_params0, points0)
    pp, pts, old_cost = pose_params0, points0, init_cost
    lam = torch.full((), config.damping, dtype=dtype, device=device)
    for it in range(config.max_iterations):
        parts = [assemble(pp.to(b.K.device), pts.to(b.K.device), b) for b in shards]
        B, C, E, gp, gx = (add_in_order([p[i] for p in parts], device) for i in range(5))
        # Pose prior, masked by pose_free like the cost.
        B = B + prior_w2 * (pose_free[:, :, None] * eye6) + lam * eye6
        gp = gp + prior_w2 * pose_free * (pp - pose_params0)
        C_inv = inv3x3(C + lam * eye3)  # (P, 3, 3)

        ECi = torch.einsum("wpij,pjk->wpik", E, C_inv)  # (W, P, 6, 3)
        S = eyeW[:, :, None, None] * B[:, None] - torch.einsum("wpik,vpjk->wvij", ECi, E)  # (W, W, 6, 6)
        rhs = -(gp - torch.einsum("wpik,pk->wi", ECi, gx))  # (W, 6)
        S_dense = S.permute(0, 2, 1, 3).reshape(W * 6, W * 6)
        S_dense = S_dense * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        if it == 0:
            # Conditioning of the data term's reduced system: on the free
            # coordinates the prior and the damping add (w² + λ)·I. Only the
            # first linearization is gated, so only it is decomposed.
            eigs = torch.linalg.eigvalsh(S_dense[free_idx][:, free_idx])
            eig_min = eigs[0] - (prior_w2 + lam)
            eig_max = eigs[-1] - (prior_w2 + lam)
        dp = _solve_pos(S_dense, rhs.reshape(-1) * free).reshape(W, 6) * pose_free
        dx = torch.einsum("pij,pj->pi", C_inv, -gx - torch.einsum("wpij,wi->pj", E, dp))

        pp_new, pts_new = pp + dp, pts + dx
        new_cost = cost_of(pp_new, pts_new)
        improved = new_cost < old_cost
        # LM schedule: accept and relax on improvement, reject and stiffen
        # (the rejected step re-linearizes at the same point).
        pp = torch.where(improved, pp_new, pp)
        pts = torch.where(improved, pts_new, pts)
        lam = torch.where(improved, torch.clamp_min(lam * 0.3, config.damping), torch.clamp_max(lam * 10.0, 1e6))
        old_cost = torch.where(improved, new_cost, old_cost)
    return pp, pts, init_cost, old_cost, eig_min, eig_max


def _ba_core_packed(pose_params0, points0, obs_pose, obs_point, obs_uv, obs_mask, K, config, num_poses, tables,
                    shards=None):
    """:func:`_ba_core` with everything the host needs in ONE float32
    tensor: ``[init, final, eig_min, eig_max, poses(W·16), points(P·3)]``."""
    pp, pts, init_cost, final_cost, eig_min, eig_max = _ba_core(
        pose_params0, points0, obs_pose, obs_point, obs_uv, obs_mask, K, config, num_poses, tables, shards
    )
    head = torch.stack([init_cost, final_cost, eig_min, eig_max])
    return torch.cat([head, _params_to_pose(pp).reshape(-1), pts.reshape(-1)]).to(torch.float32)


def run_bundle_adjustment(
    poses: np.ndarray,  # (W, 4, 4) world-from-camera
    points: np.ndarray,  # (P, 3)
    observations: List[Observation],
    K: np.ndarray,
    config: Optional[BundleAdjustmentConfig] = None,
    max_observations: Optional[int] = None,
    device="cuda",
    observation_sharding: Optional[NamedSharding] = None,
) -> BAResult:
    """Refine window poses and points on ``device`` (the card unless the
    caller asks for the CPU); one upload, one fetch.

    ``observation_sharding`` splits the padded observation budget over its
    mesh (the budget must divide by the mesh size): slot s linearizes its
    block on its device; everything else runs on slot 0's device, which
    then replaces ``device``. Results match the unsharded solve to float
    tolerance and are bit-equal run to run for a fixed mesh (see
    :func:`mvslam_tpu_torch.parallel.mesh.run_bundle_adjustment_sharded`).
    """
    config = config or BundleAdjustmentConfig()
    W = poses.shape[0]
    P = points.shape[0]
    O = len(observations)
    if O == 0 or P == 0 or W < 2:
        return BAResult(np.asarray(poses), np.asarray(points), BundleAdjustmentDiagnostics(0.0, 0.0, 0, True, False, 1.0))

    budget = max_observations or max(64, 1 << (O - 1).bit_length())
    obs_pose = np.zeros(budget, np.int64)
    obs_point = np.zeros(budget, np.int64)
    obs_uv = np.zeros((budget, 2), np.float32)
    obs_mask = np.zeros(budget, bool)
    for k, obs in enumerate(observations[:budget]):
        obs_pose[k] = obs.pose_index
        obs_point[k] = obs.point_index
        obs_uv[k] = obs.uv
        obs_mask[k] = True
    # Points padded to a power-of-two budget, as the reference: padded
    # points carry no observations, so their gradient is zero and the
    # damping keeps their C blocks invertible.
    pbudget = max(64, 1 << (P - 1).bit_length())
    points_padded = np.zeros((pbudget, 3), np.float32)
    points_padded[:P] = points

    def put(a, dtype=None, on=None):
        return torch.as_tensor(a, dtype=dtype, device=device if on is None else on)

    if observation_sharding is None:
        obs_args = (put(obs_pose), put(obs_point), put(obs_uv), put(obs_mask))
        tables, shards = ba_tables(obs_pose, obs_point, obs_mask, W, pbudget, device), None
    else:
        mesh = observation_sharding.mesh
        if budget % mesh.size:
            raise ValueError(f"observation budget ({budget}) must divide by mesh size {mesh.size}")
        device = mesh.devices[0]
        obs_args, tables = (None, None, None, None), None
        shards = [
            ObservationBlock(
                put(obs_pose[lo:hi], on=dev), put(obs_point[lo:hi], on=dev), put(obs_uv[lo:hi], on=dev),
                put(obs_mask[lo:hi], on=dev), put(K, torch.float32, on=dev),
                ba_tables(obs_pose[lo:hi], obs_point[lo:hi], obs_mask[lo:hi], W, pbudget, dev),
            )
            for (lo, hi), dev in zip(blocks(budget, mesh.size), mesh.devices)
        ]
    packed = _ba_core_packed(
        _pose_params(put(poses, torch.float32)), put(points_padded), *obs_args, put(K, torch.float32),
        config, W, tables, shards,
    ).cpu().numpy()  # ONE device→host copy for scalars, poses and points
    init_cost, final_cost, eig_min, eig_max = (float(x) for x in packed[:4])
    refined_poses = packed[4 : 4 + W * 16].reshape(W, 4, 4).astype(np.float64)
    refined_points = packed[4 + W * 16 :].reshape(pbudget, 3).astype(np.float64)[:P]
    cond = eig_max / max(eig_min, 1e-30) if eig_max > 0 else np.inf

    tripped = (
        cond > config.max_condition_number
        or eig_min < config.min_singular_value
        or not np.isfinite(refined_poses).all()
        or not np.isfinite(refined_points).all()
        or final_cost > init_cost * 1.001 + 1e-9
    )
    if tripped:
        diag = BundleAdjustmentDiagnostics(init_cost, init_cost, 0, False, True, cond)
        return BAResult(np.asarray(poses), np.asarray(points), diag)
    diag = BundleAdjustmentDiagnostics(init_cost, final_cost, config.max_iterations, final_cost <= init_cost, False, cond)
    return BAResult(refined_poses, refined_points, diag)


def triangulate_points(
    pose1: np.ndarray, pose2: np.ndarray, uv1: np.ndarray, uv2: np.ndarray, K: np.ndarray
) -> np.ndarray:
    """Triangulate matched pixels from two world-from-camera poses (batched
    DLT in float64 numpy: the window assembler calls it per span with
    irregular point counts, on the host)."""

    def proj(T):
        T_cw = np.linalg.inv(np.asarray(T, np.float64))
        return np.asarray(K, np.float64) @ T_cw[:3, :]

    def rows(P, pts):
        u = pts[:, 0:1]
        v = pts[:, 1:2]
        return np.stack([u * P[2:3, :] - P[0:1, :], v * P[2:3, :] - P[1:2, :]], axis=1)  # (N, 2, 4)

    uv1 = np.asarray(uv1, np.float64)
    uv2 = np.asarray(uv2, np.float64)
    A = np.concatenate([rows(proj(pose1), uv1), rows(proj(pose2), uv2)], axis=1)  # (N, 4, 4)
    _, _, Vt = np.linalg.svd(A)
    X = Vt[:, -1, :]  # smallest right singular vector per point
    w = X[:, 3]
    scale = np.where(np.abs(w) < 1e-12, 1e-12, w)
    return (X[:, :3] / scale[:, None]).astype(np.float64)


_PAIR_GATE_M = 192  # max matches per window pair


def _gated_pair_packed(key, a_id, b_id, descA, validA, kpA, descB, validB, kpB, K, thresh):
    """The pair gate of one keyframe pair, on the tensors' device:
    cross-checked matching, the best ``_PAIR_GATE_M`` matches, an essential
    RANSAC over them (128 hypotheses, the key folded with both frame ids),
    packed as float32 ``[pairs_a (M), pairs_b (M), mask (M)]``, the mask
    being the selection's validity AND the inliers when the fit succeeded."""
    res = matcher_for(descA.device)(descA, validA, descB, validB, MatchConfig(cross_check=True))
    sel = select_matches(res, max_matches=_PAIR_GATE_M)
    p1, p2 = gather_matched_points(kpA, kpB, sel)
    r = ransac_essential(
        prng.fold_in(prng.fold_in(key, a_id), b_id),
        normalize_pixels(p1, K),
        normalize_pixels(p2, K),
        sel.valid,
        RansacConfig(num_hypotheses=128, min_inliers=8),
        threshold=thresh,
    )
    mask = sel.valid & torch.where(r.success, r.inliers, torch.ones_like(r.inliers))
    return torch.cat([sel.pairs[:, 0].to(torch.float32), sel.pairs[:, 1].to(torch.float32), mask.to(torch.float32)])


class WindowBundleAdjuster:
    """Builds observations from a keyframe window and refines its poses in
    place, on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(
        self,
        K: np.ndarray,
        config: Optional[BundleAdjustmentConfig] = None,
        max_track_error_px: float = 12.0,
        max_pose_move_ratio: float = 0.6,
        device="cuda",
        recorder: Optional[RunTelemetryRecorder] = None,
    ) -> None:
        self.K = np.asarray(K)
        self.recorder = recorder
        self.config = config or BundleAdjustmentConfig()
        self.max_track_error_px = float(max_track_error_px)
        self.max_pose_move_ratio = float(max_pose_move_ratio)
        self.device = torch.device(device)
        self.last_diagnostics: Optional[BundleAdjustmentDiagnostics] = None
        # RANSAC-gated match pairs per (frame_id_a, frame_id_b): a sliding
        # window of W keyframes shares W-2 consecutive pairs with the
        # previous call. Matching depends only on the two keyframes'
        # features, so entries never go stale; bounded by the window size.
        self._pair_cache: dict = {}
        matcher_for(self.device)  # on the CPU: builds the C++ matcher now, not in the first gate

    def _gate_pair(self, key, a, b) -> np.ndarray:
        """(n, 2) gated match pairs of keyframes a and b (one upload of the
        two feature sets, one fetch)."""

        def put(arr, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype, device=self.device)

        buf = _gated_pair_packed(
            key, a.frame_id, b.frame_id,
            put(np.ascontiguousarray(a.descriptors).view(np.int32)), put(a.valid), put(a.keypoints, torch.float32),
            put(np.ascontiguousarray(b.descriptors).view(np.int32)), put(b.valid), put(b.keypoints, torch.float32),
            put(self.K, torch.float32), 2.0 / float(self.K[0, 0]),
        ).cpu().numpy()
        M = _PAIR_GATE_M
        mask = buf[2 * M :] > 0.5
        return np.stack([buf[:M].astype(np.int64), buf[M : 2 * M].astype(np.int64)], axis=1)[mask]

    def refine_window(self, window, key=None) -> Optional[BAResult]:
        """Refine the window's keyframe poses in place; None where the window
        gives too little to solve. With a recorder, its three parts are
        spans: ``ba_gate`` (each pair gate the cache misses), ``ba_tracks``
        (track chaining, triangulation and the reprojection gate) and
        ``ba_solve`` (the solve, which ends in its one fetch)."""
        if len(window) < 2:
            return None
        key = prng.key(0, self.device) if key is None else key.to(self.device)
        poses = np.stack([kf.pose for kf in window])
        gated = []
        for k in range(len(window) - 1):
            a, b = window[k], window[k + 1]
            cache_key = (a.frame_id, b.frame_id)
            pairs = self._pair_cache.get(cache_key)
            if pairs is None:
                with timed_event(self.recorder, "ba_gate", metadata={"pair": [a.frame_id, b.frame_id]}):
                    pairs = self._gate_pair(key, a, b)
                self._pair_cache[cache_key] = pairs
                if len(self._pair_cache) > 4 * max(len(window), 2):  # keep pairs that can recur
                    self._pair_cache.pop(next(iter(self._pair_cache)))
            gated.append(pairs)
        with timed_event(self.recorder, "ba_tracks"):
            built = self._observations(window, poses, gated)
        if built is None:
            return None
        kept_points, observations = built
        with timed_event(self.recorder, "ba_solve", metadata={"points": len(kept_points)}):
            result = run_bundle_adjustment(poses, np.stack(kept_points), observations, self.K, self.config,
                                           device=self.device)
        self.last_diagnostics = result.diagnostics
        # Update-magnitude gate: a pose dragged beyond a share of the
        # keyframe spacing escaped along a weak monocular mode.
        spacing = np.median(np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1))
        moves = np.linalg.norm(result.poses[:, :3, 3] - poses[:, :3, 3], axis=1)
        if moves.max() > self.max_pose_move_ratio * max(spacing, 1e-9):
            result.diagnostics.conditioning_tripped = True
        if not result.diagnostics.conditioning_tripped:
            for kf, pose in zip(window, result.poses):
                kf.pose = pose
        return result

    def _observations(self, window, poses, gated):
        """The kept points and their observations from each consecutive
        pair's gated matches ``gated``; None where too few survive."""
        # Chain the RANSAC-gated consecutive matches into multi-view tracks
        # (feature i in kf k matched to j in kf k+1 extends i's track).
        track_obs: List[List[tuple]] = []  # track -> [(kf_idx, feature_idx)]
        prev_assign: dict = {}
        for k, pairs in enumerate(gated):
            cur_assign: dict = {}
            for i, j in pairs:
                tid = prev_assign.get(int(i))
                if tid is None:
                    tid = len(track_obs)
                    track_obs.append([(k, int(i))])
                track_obs[tid].append((k + 1, int(j)))
                cur_assign[int(j)] = tid
            prev_assign = cur_assign
        # Triangulate each track from its first/last observation (widest
        # baseline), batched per (first, last) keyframe pair.
        tracks = [t for t in track_obs if len(t) >= 2]
        if len(tracks) < 8:
            return None
        by_span: dict = {}
        for tid, t in enumerate(tracks):
            by_span.setdefault((t[0][0], t[-1][0]), []).append(tid)
        points = np.zeros((len(tracks), 3))
        good = np.zeros(len(tracks), dtype=bool)
        for (ka, kb), tids in by_span.items():
            uv1 = np.stack([window[ka].keypoints[tracks[t][0][1]] for t in tids])
            uv2 = np.stack([window[kb].keypoints[tracks[t][-1][1]] for t in tids])
            X = triangulate_points(poses[ka], poses[kb], uv1, uv2, self.K)
            ok = np.isfinite(X).all(axis=1) & (np.abs(X) < 1e4).all(axis=1)
            for row, t in enumerate(tids):
                points[t] = X[row]
                good[t] = ok[row]
        if not good.any():
            return None  # degenerate window: every triangulation failed the sanity gate
        # Gate each track on its worst initial reprojection error under the
        # current poses: one wrong link poisons a whole track.
        obs_k = np.asarray([k for tid, t in enumerate(tracks) if good[tid] for k, _ in t])
        obs_tid = np.asarray([tid for tid, t in enumerate(tracks) if good[tid] for _ in t])
        obs_uv = np.stack(
            [window[k].keypoints[f] for tid, t in enumerate(tracks) if good[tid] for k, f in t]
        ).astype(np.float64)
        T_cw = np.linalg.inv(poses)  # (W, 4, 4)
        cam = np.einsum("oij,oj->oi", T_cw[obs_k, :3, :3], points[obs_tid]) + T_cw[obs_k, :3, 3]
        z = np.where(np.abs(cam[:, 2]) < 1e-9, 1e-9, cam[:, 2])
        u = self.K[0, 0] * cam[:, 0] / z + self.K[0, 2]
        v = self.K[1, 1] * cam[:, 1] / z + self.K[1, 2]
        err = np.hypot(u - obs_uv[:, 0], v - obs_uv[:, 1])
        err = np.where(cam[:, 2] > 0, err, np.inf)
        worst = np.zeros(len(tracks))
        np.maximum.at(worst, obs_tid, err)
        good[worst > self.max_track_error_px] = False

        observations: List[Observation] = []
        kept_points: List[np.ndarray] = []
        for tid, t in enumerate(tracks):
            if not good[tid]:
                continue
            pt_id = len(kept_points)
            kept_points.append(points[tid])
            for k, feat in t:
                observations.append(Observation(k, pt_id, window[k].keypoints[feat].astype(np.float64)))
        if len(kept_points) < 8:
            return None
        return kept_points, observations
