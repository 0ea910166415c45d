"""Robust dual-model relative pose estimation with stability gates.

Port of ``mvslam_tpu/frontend/pose_estimator.py``: an essential-matrix
and a homography candidate per frame pair (one fused RANSAC chain), both
decompositions, parallax and cheirality statistics, and the support-share
model selection, all batched over leading axes (the frame pairs of a
window). The host applies the stability gates; :class:`RobustPoseEstimator`
is the host facade for one pair, returning a :class:`PoseEstimate`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.geometry.epipolar import (
    decompose_essential,
    decompose_homography,
    _matvec3,
    sampson_error,
    triangulate_normalized,
)
from mvslam_tpu_torch.geometry.linalg import inv3x3
from mvslam_tpu_torch.geometry.projection import normalize_pixels
from mvslam_tpu_torch.ops.ransac import RansacConfig, nanmedian, ransac_dual_model


@dataclass(frozen=True)
class RobustPoseEstimatorConfig:
    """Same fields and defaults as the reference's config."""

    num_hypotheses: int = 512
    # 0 ⇒ num_hypotheses // 2 (4-point samples reach the same confidence
    # with far fewer hypotheses than 8-point ones).
    homography_hypotheses: int = 0
    essential_threshold_px: float = 1.5
    homography_threshold_px: float = 3.0
    adaptive_threshold: bool = True
    min_matches: int = 12
    min_inliers: int = 15
    min_inlier_ratio: float = 0.25
    min_parallax_deg: float = 0.15
    min_cheirality_ratio: float = 0.55
    min_displacement_px: float = 0.75  # median inlier flow below this = stationary
    essential_bias: float = 1.0
    homography_bias: float = 0.85
    homography_selection_share: float = 0.42
    homography_force_share: float = 0.52
    refit_rounds: int = 2
    # True = the dual-model RANSAC and the selection's support votes run
    # through the order-pinned forms (ops.ransac.RansacConfig.mesh_invariant):
    # a pair gets the same bits in any batch of pairs. The meshed tracking
    # paths (parallel/mesh.py) force it.
    mesh_invariant: bool = False

    def __post_init__(self):
        if self.min_inliers < 8:
            raise ValueError("min_inliers must be >= 8")
        if not 0.0 <= self.min_inlier_ratio <= 1.0:
            raise ValueError("min_inlier_ratio must be in [0, 1]")


class PoseEstimationFailure(Exception):
    """Tracking-loss signal consumed by the relocalization path."""

    def __init__(self, reason: str, metrics: Optional[Dict] = None, recovery_action: str = "relocalize"):
        super().__init__(reason)
        self.reason = reason
        self.recovery_action = recovery_action
        self.metrics = dict(metrics or {})


@dataclass(frozen=True)
class PoseEstimate:
    """Host-side result of a successful estimation."""

    rotation: np.ndarray  # (3, 3)
    translation: np.ndarray  # (3,) unit norm
    model_type: str  # "essential" | "homography"
    num_inliers: int
    inlier_ratio: float
    median_parallax_deg: float
    cheirality_ratio: float
    score: float
    inlier_mask: np.ndarray = field(repr=False, default=None)


class DevicePoseResult(NamedTuple):
    """Raw device outputs of the fused dual-model estimate (leading axes
    as the inputs')."""

    rotation: torch.Tensor  # (..., 3, 3)
    translation: torch.Tensor  # (..., 3) unit
    use_essential: torch.Tensor  # (...) bool
    num_inliers: torch.Tensor  # (...) int32
    inlier_ratio: torch.Tensor  # (...) float32
    median_parallax_deg: torch.Tensor  # (...) float32
    cheirality_ratio: torch.Tensor  # (...) float32
    score: torch.Tensor  # (...) float32
    essential_score: torch.Tensor
    homography_score: torch.Tensor
    inliers: torch.Tensor  # (..., N) bool
    num_valid_matches: torch.Tensor  # (...) int32
    median_displacement_px: torch.Tensor  # (...) float32 — zero-motion detector
    homography_share: torch.Tensor  # (...) float32 — S_H/(S_H+S_E) selection ratio


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(dim=-1))


def _parallax_and_cheirality(R, t, pts1, pts2, inliers):
    """Median parallax angle (deg) and positive-depth ratio over inliers."""
    X = triangulate_normalized(R, t, pts1, pts2)  # (..., N, 3) in cam1
    z1 = X[..., 2]
    z2 = (X @ R.transpose(-1, -2) + t[..., None, :])[..., 2]
    w = inliers.to(X.dtype)
    front = ((z1 > 1e-6) & (z2 > 1e-6)).to(X.dtype)
    cheirality = (front * w).sum(dim=-1) / w.sum(dim=-1).clamp_min(1.0)
    # Parallax: angle between the two viewing rays of each point.
    c2 = -(R.transpose(-1, -2) @ t[..., :, None])[..., 0]  # camera-2 centre in cam1
    r2 = X - c2[..., None, :]
    dot = (X * r2).sum(dim=-1)
    norms = _norm(X) * _norm(r2)
    cosang = (dot / torch.where(norms < 1e-12, torch.full_like(norms, 1e-12), norms)).clamp(-1.0, 1.0)
    ang = torch.arccos(cosang) * (180.0 / math.pi)
    median = nanmedian(torch.where(inliers, ang, torch.full_like(ang, float("nan"))))
    return torch.where(torch.isnan(median), torch.zeros_like(median), median), cheirality


def estimate_pose_device(
    key: torch.Tensor,
    pts1_px: torch.Tensor,
    pts2_px: torch.Tensor,
    mask: torch.Tensor,
    K: torch.Tensor,
    config: RobustPoseEstimatorConfig = RobustPoseEstimatorConfig(),
) -> DevicePoseResult:
    """Fused dual-model pose estimation for frame pairs.

    key (..., 2), pts (..., N, 2) pixels, mask (..., N), K (3, 3).
    """
    fx = K[..., 0, 0]
    n1 = normalize_pixels(pts1_px, K)
    n2 = normalize_pixels(pts2_px, K)

    # ONE masked median of the match displacements serves both adaptive
    # thresholds and the zero-motion detector.
    nan = torch.full_like(pts1_px[..., 0], float("nan"))
    median_nan = nanmedian(torch.where(mask, _norm(pts2_px - pts1_px), nan))
    is_nan = torch.isnan(median_nan)
    median_disp = torch.where(is_nan, torch.zeros_like(median_nan), median_nan)

    e_thresh_px = torch.full_like(median_nan, config.essential_threshold_px)
    h_thresh = torch.full_like(median_nan, config.homography_threshold_px)
    if config.adaptive_threshold:
        median_t = torch.where(is_nan, torch.full_like(median_nan, 25.0), median_nan)
        scale = (median_t / 25.0).clamp(0.5, 2.0)
        e_thresh_px = config.essential_threshold_px * scale
        h_thresh = config.homography_threshold_px * scale

    keys = prng.split(key)
    ransac_cfg = RansacConfig(
        num_hypotheses=config.num_hypotheses,
        min_inliers=config.min_inliers,
        refit_rounds=config.refit_rounds,
        mesh_invariant=config.mesh_invariant,
    )
    ransac_cfg_h = RansacConfig(
        num_hypotheses=config.homography_hypotheses or config.num_hypotheses // 2,
        min_inliers=config.min_inliers,
        refit_rounds=config.refit_rounds,
        mesh_invariant=config.mesh_invariant,
    )
    # Both models are fit in normalised coordinates; pixel thresholds
    # convert by 1/fx.
    dual = ransac_dual_model(
        keys[..., 0, :], keys[..., 1, :], n1, n2, mask, ransac_cfg, ransac_cfg_h,
        threshold_e=e_thresh_px / fx, threshold_h=h_thresh / fx,
    )
    res_e, res_h = dual.essential, dual.homography

    R_e, t_e, _ = decompose_essential(res_e.model, n1, n2, weights=res_e.inliers.to(torch.float32))
    R_h, t_h, _ = decompose_homography(res_h.model, n1, n2)
    # Both models' triangulation statistics as one batched chain.
    par, che = _parallax_and_cheirality(
        torch.stack([R_e, R_h], dim=-3),
        torch.stack([t_e, t_h], dim=-2),
        n1[..., None, :, :],
        n2[..., None, :, :],
        torch.stack([res_e.inliers, res_h.inliers], dim=-2),
    )
    par_e, par_h = par[..., 0], par[..., 1]
    che_e, che_h = che[..., 0], che[..., 1]

    zero = torch.zeros_like(par_e)
    min_par = config.min_parallax_deg
    score_e = torch.where(
        res_e.success, config.essential_bias * res_e.inlier_ratio * par_e.clamp_min(min_par), zero
    )
    score_h = torch.where(
        res_h.success, config.homography_bias * res_h.inlier_ratio * par_h.clamp_min(min_par), zero
    )
    # Selection by support share S_H/(S_H+S_E): both models voted on ALL
    # valid matches under the same chi² 95% pixel cutoff (E via Sampson,
    # counted twice; H via forward and backward transfer).
    sigma_sq = (e_thresh_px / 1.96) ** 2
    cutoff = (3.84 * sigma_sq)[..., None]
    fx_ = fx[..., None]
    pinned = config.mesh_invariant
    d2_e = sampson_error(res_e.model, n1, n2, pinned) * fx_ * fx_

    def _transfer_sq(M, src, dst):
        y = _matvec3(M, torch.cat([src, torch.ones_like(src[..., :1])], dim=-1), pinned)
        w = y[..., 2:3]
        w = torch.where(w.abs() < 1e-12, torch.full_like(w, 1e-12), w)
        d = y[..., :2] / w - dst
        return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] if pinned else (d * d).sum(dim=-1)

    d2_h_fwd = _transfer_sq(res_h.model, n1, n2) * fx_ * fx_
    d2_h_bwd = _transfer_sq(inv3x3(res_h.model), n2, n1) * fx_ * fx_

    def _rho(d2):
        return (mask & (d2 < cutoff)).to(torch.float32).sum(dim=-1)

    s_e = 2.0 * _rho(d2_e)
    s_h = _rho(d2_h_fwd) + _rho(d2_h_bwd)
    h_share = s_h / (s_h + s_e).clamp_min(1e-9)
    prefer_h = (h_share > config.homography_force_share) | (
        (h_share >= config.homography_selection_share) & (score_h > score_e)
    )
    # A model whose decomposition would trip the cheirality/parallax gates
    # must not win while the other model would pass them.
    healthy_e = res_e.success & (che_e >= config.min_cheirality_ratio) & (par_e >= min_par)
    healthy_h = res_h.success & (che_h >= config.min_cheirality_ratio) & (par_h >= min_par)
    use_e = torch.where(
        healthy_e & healthy_h,
        ~prefer_h,
        torch.where(healthy_e | healthy_h, healthy_e, res_e.success),
    )

    R = torch.where(use_e[..., None, None], R_e, R_h)
    t = torch.where(use_e[..., None], t_e, t_h)
    t = t / _norm(t).clamp_min(1e-12)[..., None]

    return DevicePoseResult(
        rotation=R,
        translation=t,
        use_essential=use_e,
        num_inliers=torch.where(use_e, res_e.num_inliers, res_h.num_inliers),
        inlier_ratio=torch.where(use_e, res_e.inlier_ratio, res_h.inlier_ratio),
        median_parallax_deg=torch.where(use_e, par_e, par_h),
        cheirality_ratio=torch.where(use_e, che_e, che_h),
        score=torch.maximum(score_e, score_h),
        essential_score=score_e,
        homography_score=score_h,
        inliers=torch.where(use_e[..., None], res_e.inliers, res_h.inliers),
        num_valid_matches=mask.sum(dim=-1).to(torch.int32),
        median_displacement_px=median_disp.to(torch.float32),
        homography_share=h_share.to(torch.float32),
    )


def apply_stability_gates(config: RobustPoseEstimatorConfig, metrics: Dict) -> None:
    """Raise :class:`PoseEstimationFailure` when a gate trips."""
    if metrics.get("num_matches", 0) < config.min_matches:
        raise PoseEstimationFailure("insufficient_matches", metrics=metrics)
    if metrics.get("median_displacement_px", float("inf")) < config.min_displacement_px:
        raise PoseEstimationFailure("insufficient_motion", metrics=metrics)
    if metrics.get("score", 0.0) <= 0.0:
        raise PoseEstimationFailure("no_valid_model", metrics=metrics)
    if metrics.get("num_inliers", 0) < config.min_inliers:
        raise PoseEstimationFailure("low_inliers", metrics=metrics)
    if metrics.get("inlier_ratio", 0.0) < config.min_inlier_ratio:
        raise PoseEstimationFailure("low_inlier_ratio", metrics=metrics)
    if metrics.get("median_parallax_deg", 0.0) < config.min_parallax_deg:
        raise PoseEstimationFailure("low_parallax", metrics=metrics)
    if metrics.get("cheirality_ratio", 0.0) < config.min_cheirality_ratio:
        raise PoseEstimationFailure("low_cheirality", metrics=metrics)


class RobustPoseEstimator:
    """Host facade on ``device`` (default ``"cuda"``): the fused dual-model
    estimate of one frame pair, then the stability gates."""

    def __init__(self, config: Optional[RobustPoseEstimatorConfig] = None, device="cuda") -> None:
        self.config = config or RobustPoseEstimatorConfig()
        self.device = torch.device(device)

    def estimate_pose(self, pts1_px, pts2_px, mask, K, key) -> PoseEstimate:
        """(N, 2) pixel points of each frame, (N,) mask, (3, 3) K and a (2,)
        key, arrays or tensors, moved to the estimator's device. Raises
        :class:`PoseEstimationFailure` when a gate trips."""
        cfg = self.config
        device = self.device
        pts1_px = torch.as_tensor(pts1_px, dtype=torch.float32, device=device)
        pts2_px = torch.as_tensor(pts2_px, dtype=torch.float32, device=device)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=device)
        num_matches = int(mask.sum())
        if num_matches < cfg.min_matches:
            raise PoseEstimationFailure(
                "insufficient_matches",
                metrics={"num_matches": num_matches, "min_matches": cfg.min_matches},
            )
        K = torch.as_tensor(K, dtype=torch.float32, device=device)
        key = torch.as_tensor(key, dtype=torch.int64, device=device)
        dev = estimate_pose_device(key[None], pts1_px[None], pts2_px[None], mask[None], K, cfg)
        dev = DevicePoseResult(*(a[0] for a in dev))
        metrics = {
            "num_matches": num_matches,
            "num_inliers": int(dev.num_inliers),
            "inlier_ratio": float(dev.inlier_ratio),
            "median_parallax_deg": float(dev.median_parallax_deg),
            "cheirality_ratio": float(dev.cheirality_ratio),
            "score": float(dev.score),
            "essential_score": float(dev.essential_score),
            "homography_score": float(dev.homography_score),
            "model_type": "essential" if bool(dev.use_essential) else "homography",
            "median_displacement_px": float(dev.median_displacement_px),
        }
        apply_stability_gates(cfg, metrics)
        return PoseEstimate(
            rotation=dev.rotation.cpu().numpy(),
            translation=dev.translation.cpu().numpy(),
            model_type=metrics["model_type"],
            num_inliers=metrics["num_inliers"],
            inlier_ratio=metrics["inlier_ratio"],
            median_parallax_deg=metrics["median_parallax_deg"],
            cheirality_ratio=metrics["cheirality_ratio"],
            score=metrics["score"],
            inlier_mask=dev.inliers.cpu().numpy(),
        )
