"""Hypothesis-parallel RANSAC: single-model (essential or homography) and
dual-model (both in one solver chain).

Port of ``mvslam_tpu/ops/ransac.py``: K
minimal samples are drawn with a masked Gumbel-top-k from threefry bits
(``core.prng``, bit-identical to ``jax.random``), all hypotheses of both
models are solved as one batched null-space problem, all K×N residuals
are scored at once, and the best hypothesis of each model is refit on its
inliers (static IRLS rounds). Batched over leading axes (frames).

Which reduction form a call takes is a rule of the reference's that
this package keeps (:func:`_auto_pinned`): the order-pinned solvers and
scorers (``geometry.epipolar``'s ``pinned`` forms) at N ≤ 1,024
correspondences, the matmul and sum forms above, and the pinned forms at
every N under ``RansacConfig.mesh_invariant``. A hypothesis solved in the
pinned forms gets the same bits whatever batch it is solved in, which is
what lets ``ransac_essential``/``ransac_homography`` split the hypothesis
axis over a mesh (``hypothesis_sharding``) without changing a bit of the
result.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import torch

from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.core.sharding import NamedSharding, blocks, concat
from mvslam_tpu_torch.geometry.epipolar import (
    HYPOTHESIS_EIGVEC_ITERS,
    REFIT_EIGVEC_ITERS,
    _smallest_singular_vector,
    _take,
    dlt_homography,
    eight_point_essential,
    essential_from_vec,
    essential_rows,
    homography_from_vec,
    homography_rows,
    sampson_error,
    symmetric_transfer_error,
)
from mvslam_tpu_torch.ops.fast import topk_stable


@dataclass(frozen=True)
class RansacConfig:
    num_hypotheses: int = 512
    threshold: float = 1.0  # residual threshold (normalised units for E, px for H)
    min_inliers: int = 15
    refit_rounds: int = 2
    # True = solve and score through the order-pinned, elementwise-only
    # forms at every N, so every hypothesis gets the same bits in any batch
    # (a mesh block, a slice): the meshed wrappers in parallel/mesh.py force
    # it. False (default) = the form follows the correspondence count N
    # (_auto_pinned): pinned at N <= 1024, matmul and sum forms above.
    mesh_invariant: bool = False


# The reduction rule of the reference's RANSAC: pinned forms at N ≤ 1,024
# correspondences (every tracking pair at 512 matches, the accuracy
# scenes' 256, the pair gate's 192, loop geometry and relocalization at
# 256), matmul and sum forms above (flow-first at 2,048 features). It
# fixes the arithmetic as well as the speed: at these sizes this package
# adds in the order the reference's source writes.
_PINNED_N_CUTOFF = 1024


def _auto_pinned(n: int, *configs: RansacConfig) -> bool:
    """True where a call on N correspondences takes the order-pinned forms:
    any config's ``mesh_invariant``, or N ≤ :data:`_PINNED_N_CUTOFF`."""
    return any(c.mesh_invariant for c in configs) or n <= _PINNED_N_CUTOFF


class RansacResult(NamedTuple):
    model: torch.Tensor  # (..., 3, 3)
    inliers: torch.Tensor  # (..., N) bool
    num_inliers: torch.Tensor  # (...) int32
    inlier_ratio: torch.Tensor  # (...) float32 (vs valid correspondences)
    success: torch.Tensor  # (...) bool


class DualRansacResult(NamedTuple):
    essential: RansacResult
    homography: RansacResult


def _sample_indices(key: torch.Tensor, mask: torch.Tensor, num_hypotheses: int, sample_size: int) -> torch.Tensor:
    """(..., K, sample_size) distinct valid indices via masked Gumbel-top-k.

    key (..., 2), mask (..., N). Ties resolve to the lower index, as in
    ``jax.lax.top_k``.
    """
    n = mask.shape[-1]
    u = prng.uniform(key, (num_hypotheses, n), minval=1e-12, maxval=1.0)
    gumbel = -torch.log(-torch.log(u))
    scores = torch.where(mask[..., None, :], gumbel, torch.full_like(gumbel, -float("inf")))
    return topk_stable(scores, sample_size)[1]


def _gather_points(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """pts (..., N, 2), idx (..., K, S) → (..., K, S, 2)."""
    k, s = idx.shape[-2:]
    flat = idx.reshape(*idx.shape[:-2], k * s, 1).expand(*idx.shape[:-2], k * s, 2)
    return torch.gather(pts, -2, flat).reshape(*idx.shape, 2)


def _as_threshold_sq(threshold, like: torch.Tensor) -> torch.Tensor:
    if isinstance(threshold, (int, float)):  # a fill, not a host-to-device copy: capturable in a CUDA graph
        t = torch.full((), threshold, dtype=like.dtype, device=like.device)
    else:
        t = torch.as_tensor(threshold, dtype=like.dtype, device=like.device)
    return t * t


def _vote(idx, pts1, pts2, mask, thr2, solver, scorer):
    """Solve and score the hypotheses ``idx`` (..., K, S); returns the
    winner's (votes, model, inliers), the first maximum on a tie, like
    ``jnp.argmax``."""
    models = solver(_gather_points(pts1, idx), _gather_points(pts2, idx), None)  # (..., K, 3, 3)
    inl = (scorer(models, pts1[..., None, :, :], pts2[..., None, :, :]) < thr2[..., None, None]) & mask[..., None, :]
    votes = inl.sum(dim=-1)
    best = torch.argmax(votes, dim=-1)
    return _take(votes, best, -1), _take(models, best, -3), _take(inl, best, -2)


def _vote_sharded(idx, pts1, pts2, mask, thr2, solver, scorer, sharding: NamedSharding):
    """:func:`_vote` with the hypothesis axis split over the mesh: slot s
    solves and scores its block against the correspondences placed on its
    device; the winner across slots is the lexicographic pick (most votes,
    then lowest global hypothesis index), made on slot 0's device."""
    mesh = sharding.mesh
    home = mesh.devices[0]
    picks = []
    for (lo, hi), dev in zip(blocks(idx.shape[-2], mesh.size, "num_hypotheses"), mesh.devices):
        picks.append(_vote(
            idx[..., lo:hi, :].to(dev), pts1.to(dev), pts2.to(dev), mask.to(dev), thr2.to(dev), solver, scorer
        ))
    votes = concat([p[0][..., None] for p in picks], home, dim=-1)  # (..., slots)
    models = concat([p[1][..., None, :, :] for p in picks], home, dim=-3)
    inl = concat([p[2][..., None, :] for p in picks], home, dim=-2)
    slot = torch.argmax(votes, dim=-1)  # slots in index order: the first maximum is the lowest index
    return _take(votes, slot, -1), _take(models, slot, -3), _take(inl, slot, -2)


def _ransac(key, pts1, pts2, mask, config: RansacConfig, solver, scorer, sample_size: int, threshold=None,
            hypothesis_sharding: NamedSharding | None = None) -> RansacResult:
    """Single-model RANSAC: K hypotheses from minimal samples, scored at
    once, the best refit on its inliers (static rounds). Batched over
    leading axes like :func:`ransac_dual_model`.

    The hypotheses are drawn from the one global ``key`` whatever the
    sharding; ``hypothesis_sharding`` splits only their solve and scoring
    over its mesh (see :func:`_vote_sharded`). The refit runs on the
    inputs' device."""
    thr2 = _as_threshold_sq(config.threshold if threshold is None else threshold, pts1)
    num_valid = mask.sum(dim=-1)
    idx = _sample_indices(key, mask, config.num_hypotheses, sample_size)  # (..., K, S)
    if hypothesis_sharding is None:
        _, model, inliers = _vote(idx, pts1, pts2, mask, thr2, solver, scorer)
    else:
        _, model, inliers = _vote_sharded(idx, pts1, pts2, mask, thr2, solver, scorer, hypothesis_sharding)
        model, inliers = model.to(pts1.device), inliers.to(pts1.device)
    for _ in range(config.refit_rounds):
        w = inliers.to(pts1.dtype)
        enough = w.sum(dim=-1) >= sample_size  # a refit needs a full sample's worth
        model = torch.where(enough[..., None, None], solver(pts1, pts2, w), model)
        inliers = (scorer(model, pts1, pts2) < thr2[..., None]) & mask
    count = inliers.sum(dim=-1)
    ratio = count / num_valid.clamp_min(1)
    success = (count >= config.min_inliers) & (num_valid >= sample_size)
    return RansacResult(model, inliers, count.to(torch.int32), ratio.to(torch.float32), success)


def ransac_essential(
    key, pts1, pts2, mask, config: RansacConfig = RansacConfig(threshold=2e-3), threshold=None,
    hypothesis_sharding: NamedSharding | None = None,
) -> RansacResult:
    """Essential-matrix RANSAC over normalised correspondences, Sampson
    scored; ``threshold`` (a scalar or a (...) tensor) overrides the
    config's. The reduction form follows :func:`_auto_pinned`.
    ``hypothesis_sharding`` splits the hypothesis solve and scoring over a
    mesh: in the pinned forms the result is bit-equal to the unsharded call
    on any mesh size."""
    pinned = _auto_pinned(pts1.shape[-2], config)
    return _ransac(
        key, pts1, pts2, mask, config, partial(eight_point_essential, pinned=pinned),
        partial(sampson_error, pinned=pinned), 8, threshold, hypothesis_sharding,
    )


def ransac_homography(
    key, pts1, pts2, mask, config: RansacConfig = RansacConfig(threshold=3.0), threshold=None,
    hypothesis_sharding: NamedSharding | None = None,
) -> RansacResult:
    """Homography RANSAC scored by symmetric transfer error; the reduction
    form and ``hypothesis_sharding`` as in :func:`ransac_essential`."""
    pinned = _auto_pinned(pts1.shape[-2], config)
    return _ransac(
        key, pts1, pts2, mask, config, partial(dlt_homography, pinned=pinned),
        partial(symmetric_transfer_error, pinned=pinned), 4, threshold, hypothesis_sharding,
    )


def ransac_dual_model(
    key_e: torch.Tensor,
    key_h: torch.Tensor,
    pts1: torch.Tensor,
    pts2: torch.Tensor,
    mask: torch.Tensor,
    config_e: RansacConfig,
    config_h: RansacConfig,
    threshold_e=None,
    threshold_h=None,
) -> DualRansacResult:
    """Essential + homography RANSAC in ONE solver chain.

    pts (..., N, 2) normalised, mask (..., N), keys (..., 2), thresholds
    scalars or (...) tensors (default: the configs' thresholds). E gives
    one ``kron`` row per correspondence (8 rows a sample), H two DLT rows
    (2×4 a sample), so the K_e + K_h hypothesis systems are ONE batched
    (K_e+K_h, 8, 9) null-space problem, and each refit round solves both
    models as one (2, 2N, 9) problem (E rows zero-padded: zero rows leave
    AᵀA unchanged). Both models take one reduction form:
    :func:`_auto_pinned` over N and both configs.
    """
    pinned = _auto_pinned(pts1.shape[-2], config_e, config_h)
    thr2_e = _as_threshold_sq(config_e.threshold if threshold_e is None else threshold_e, pts1)
    thr2_h = _as_threshold_sq(config_h.threshold if threshold_h is None else threshold_h, pts1)
    num_valid = mask.sum(dim=-1)
    k_e, k_h = config_e.num_hypotheses, config_h.num_hypotheses

    idx_e = _sample_indices(key_e, mask, k_e, 8)  # (..., K_e, 8)
    idx_h = _sample_indices(key_h, mask, k_h, 4)  # (..., K_h, 4)
    rows_e = essential_rows(_gather_points(pts1, idx_e), _gather_points(pts2, idx_e))
    rows_h, T1, T2 = homography_rows(_gather_points(pts1, idx_h), _gather_points(pts2, idx_h), pinned=pinned)
    # rescue=False: a numerically failed hypothesis merely loses its vote.
    vecs = _smallest_singular_vector(
        torch.cat([rows_e, rows_h], dim=-3), rescue=False, iterations=HYPOTHESIS_EIGVEC_ITERS, pinned=pinned
    )
    models_e = essential_from_vec(vecs[..., :k_e, :], exact_rank2=False, pinned=pinned)
    models_h = homography_from_vec(vecs[..., k_e:, :], T1, T2, pinned=pinned)

    p1, p2 = pts1[..., None, :, :], pts2[..., None, :, :]
    inl_e = (sampson_error(models_e, p1, p2, pinned) < thr2_e[..., None, None]) & mask[..., None, :]
    inl_h = (symmetric_transfer_error(models_h, p1, p2, pinned) < thr2_h[..., None, None]) & mask[..., None, :]
    best_e = torch.argmax(inl_e.sum(dim=-1), dim=-1)  # first maximum, like jnp.argmax
    best_h = torch.argmax(inl_h.sum(dim=-1), dim=-1)
    model_e, inliers_e = _take(models_e, best_e, -3), _take(inl_e, best_e, -2)
    model_h, inliers_h = _take(models_h, best_h, -3), _take(inl_h, best_h, -2)

    for r in range(max(config_e.refit_rounds, config_h.refit_rounds)):
        w_e = inliers_e.to(pts1.dtype)
        w_h = inliers_h.to(pts1.dtype)
        re = essential_rows(pts1, pts2, w_e)  # (..., N, 9)
        rh, T1f, T2f = homography_rows(pts1, pts2, w_h, pinned=pinned)  # (..., 2N, 9)
        re_padded = torch.cat([re, torch.zeros_like(re)], dim=-2)
        # rescue=True: a poisoned refit would poison the frame's model.
        v2 = _smallest_singular_vector(
            torch.stack([re_padded, rh], dim=-3), rescue=True, iterations=REFIT_EIGVEC_ITERS, pinned=pinned
        )
        if r < config_e.refit_rounds:
            refit_e = essential_from_vec(v2[..., 0, :], exact_rank2=True, pinned=pinned)
            model_e = torch.where((w_e.sum(dim=-1) >= 8)[..., None, None], refit_e, model_e)
            inliers_e = (sampson_error(model_e, pts1, pts2, pinned) < thr2_e[..., None]) & mask
        if r < config_h.refit_rounds:
            refit_h = homography_from_vec(v2[..., 1, :], T1f, T2f, pinned=pinned)
            model_h = torch.where((w_h.sum(dim=-1) >= 4)[..., None, None], refit_h, model_h)
            inliers_h = (symmetric_transfer_error(model_h, pts1, pts2, pinned) < thr2_h[..., None]) & mask

    def _result(model, inliers, cfg, sample_size):
        count = inliers.sum(dim=-1)
        ratio = count / num_valid.clamp_min(1)
        success = (count >= cfg.min_inliers) & (num_valid >= sample_size)
        return RansacResult(model, inliers, count.to(torch.int32), ratio.to(torch.float32), success)

    return DualRansacResult(
        essential=_result(model_e, inliers_e, config_e, 8),
        homography=_result(model_h, inliers_h, config_h, 4),
    )


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` over the last axis: the MEAN of the two middle
    values on an even count (``torch.nanmedian`` returns the lower one);
    NaN when every value is NaN."""
    s, _ = torch.sort(x, dim=-1)  # NaNs sort last
    count = (~torch.isnan(x)).sum(dim=-1, keepdim=True)
    low = ((count - 1) // 2).clamp_min(0)
    high = torch.minimum(count // 2, (count - 1).clamp_min(0))
    return (torch.gather(s, -1, low) + torch.gather(s, -1, high))[..., 0] * 0.5


def adaptive_ransac_threshold(
    base_threshold: float, pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Scale a base threshold by median match displacement / 25, clipped to
    [0.5, 2.0]x."""
    d = pts2 - pts1
    disp = torch.sqrt((d * d).sum(dim=-1))
    median = nanmedian(torch.where(mask, disp, torch.full_like(disp, float("nan"))))
    median = torch.where(torch.isnan(median), torch.full_like(median, 25.0), median)
    return base_threshold * (median / 25.0).clamp(0.5, 2.0)
