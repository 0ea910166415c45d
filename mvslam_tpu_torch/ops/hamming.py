"""Packed-Hamming descriptor matching.

Port of ``mvslam_tpu/ops/hamming.py``. With descriptors unpacked to 0/1
bit rows, ``hamming(i, j) = |b_i| + |b_j| − 2·b_i·b_j``, so the N×M
distance matrix is one bf16 product (exact for 0/1 values and sums up to
256) plus rank-1 corrections. Batched over any leading axes.

``select_matches`` orders by ascending distance with a stable sort, the
tie order of ``jax.lax.top_k`` (lower index first).

``match_descriptors_host`` is the C++ matcher of the port's native
library, equal bit for bit. ``matcher_for(device)`` is the one place that
chooses between the two: the C++ matcher for descriptors on the CPU, the
product everywhere else.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from mvslam_tpu_torch.ops.brief import unpack_bits

_BIG = 1e9


@dataclass(frozen=True)
class MatchConfig:
    ratio: float = 0.8
    cross_check: bool = True
    use_ratio_test: bool = False  # reference default: cross-check on, ratio off
    max_distance: float = 256.0


def hamming_distance_matrix(desc1: torch.Tensor, desc2: torch.Tensor) -> torch.Tensor:
    """(..., N, 8) x (..., M, 8) packed words → (..., N, M) float32 distances."""
    b1 = unpack_bits(desc1).to(torch.bfloat16)
    b2 = unpack_bits(desc2).to(torch.bfloat16)
    s1 = b1.to(torch.float32).sum(dim=-1)
    s2 = b2.to(torch.float32).sum(dim=-1)
    dot = (b1 @ b2.transpose(-1, -2)).to(torch.float32)
    return s1[..., :, None] + s2[..., None, :] - 2.0 * dot


class MatchResult(NamedTuple):
    indices: torch.Tensor  # (..., N) best index into desc2 per query
    distances: torch.Tensor  # (..., N) best distance
    second_distances: torch.Tensor  # (..., N) runner-up distance
    valid: torch.Tensor  # (..., N) bool — survived masks + cross-check + ratio


def match_descriptors(
    desc1: torch.Tensor,
    valid1: torch.Tensor,
    desc2: torch.Tensor,
    valid2: torch.Tensor,
    config: MatchConfig = MatchConfig(),
) -> MatchResult:
    """Brute-force Hamming matching with cross-check and/or Lowe ratio."""
    big = torch.tensor(_BIG, dtype=torch.float32, device=desc1.device)
    d = hamming_distance_matrix(desc1, desc2)
    d = torch.where(valid2[..., None, :], d, big)
    d = torch.where(valid1[..., :, None], d, big)
    # argmin returns the first minimum, as jnp.argmin does.
    best_idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, best_idx[..., None])[..., 0]
    cols = torch.arange(d.shape[-1], device=d.device)
    second = torch.where(cols == best_idx[..., None], big, d).amin(dim=-1)

    ok = valid1 & (best < config.max_distance) & (best < _BIG * 0.5)
    if config.use_ratio_test:
        ok = ok & (best < config.ratio * second)
    if config.cross_check:
        col_best = torch.argmin(d, dim=-2)  # (..., M) best query per train
        mutual = torch.gather(col_best, -1, best_idx) == torch.arange(d.shape[-2], device=d.device)
        ok = ok & mutual
    return MatchResult(best_idx, best, second, ok)


def match_descriptors_host(desc1, valid1, desc2, valid2, config: MatchConfig = MatchConfig()) -> MatchResult:
    """Host (C++) brute-force matcher, equal to :func:`match_descriptors`
    bit for bit (parity: ``tests/test_torch_native.py``).

    Takes (N, 8) uint32 descriptors and (N,) masks as numpy arrays or CPU
    tensors, and returns a :class:`MatchResult` of CPU tensors with
    :func:`match_descriptors`'s dtypes. The matching paths on the CPU (the
    window-BA pair gate, loop geometry, the relocalizer) take it through
    :func:`matcher_for` in place of the N x M product. Raises
    ``RuntimeError`` when the native library is unavailable.
    """
    import numpy as np

    from mvslam_tpu_torch import native

    d1, d2 = (np.ascontiguousarray(d).view(np.uint32) for d in (desc1, desc2))
    v1, v2 = (np.asarray(v, bool) for v in (valid1, valid2))
    out = native.hamming_match(d1, v1, d2, v2)
    if out is None:
        raise RuntimeError("the native host library is unavailable")
    best_idx, best, second, col_best = out
    ok = v1 & (best < config.max_distance) & (best < _BIG * 0.5)
    if config.use_ratio_test:
        ok = ok & (best < config.ratio * second)
    if config.cross_check:
        ok = ok & (col_best[best_idx] == np.arange(d1.shape[0]))
    return MatchResult(
        torch.from_numpy(best_idx.astype(np.int64)), torch.from_numpy(best), torch.from_numpy(second),
        torch.from_numpy(ok),
    )


def matcher_for(device) -> Callable[..., MatchResult]:
    """The matcher for descriptors on ``device``: on the CPU the native
    library's C++ matcher (faster there than the product: PERF.md, the
    ``native`` phase of ``chip_smoke.py``), elsewhere
    :func:`match_descriptors`.
    Both give the same :class:`MatchResult` bit for bit. On the CPU this
    builds the library if the process has not loaded it yet, so the
    matching paths' owners (``SLAMSystem``, ``WindowBundleAdjuster``,
    ``MapRelocalizer``) call it when they start, not in their first match.
    """
    if torch.device(device).type == "cpu":
        from mvslam_tpu_torch import native

        if native.native_available():
            return match_descriptors_host
    return match_descriptors


class SelectedMatches(NamedTuple):
    pairs: torch.Tensor  # (..., K, 2) int32 (query_idx, train_idx)
    distances: torch.Tensor  # (..., K)
    valid: torch.Tensor  # (..., K) bool
    num_valid: torch.Tensor  # (...) int32


def select_matches(result: MatchResult, max_matches: int = 512) -> SelectedMatches:
    """Compact per-query matches to the best ``max_matches`` by distance
    (stable: equal distances keep query order)."""
    big = torch.tensor(_BIG, dtype=torch.float32, device=result.distances.device)
    masked = torch.where(result.valid, result.distances, big)
    k = min(max_matches, masked.shape[-1])
    dist, rows = torch.sort(masked, dim=-1, stable=True)
    dist, rows = dist[..., :k], rows[..., :k]
    valid = dist < _BIG * 0.5
    pairs = torch.stack([rows, torch.gather(result.indices, -1, rows)], dim=-1).to(torch.int32)
    pairs = torch.where(valid[..., None], pairs, torch.zeros((), dtype=torch.int32, device=pairs.device))
    if k < max_matches:
        pad = max_matches - k
        pairs = F.pad(pairs, (0, 0, 0, pad))
        dist = F.pad(dist, (0, pad), value=_BIG)
        valid = F.pad(valid, (0, pad))
    distances = torch.where(valid, dist, torch.zeros((), dtype=dist.dtype, device=dist.device))
    return SelectedMatches(pairs, distances, valid, valid.sum(dim=-1).to(torch.int32))


def gather_matched_points(
    xy1: torch.Tensor, xy2: torch.Tensor, selected: SelectedMatches
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K, 2) matched pixel coordinates in each frame (masked slots → 0)."""

    def take(xy, idx):
        return torch.gather(xy, -2, idx.to(torch.int64)[..., None].expand(*idx.shape, 2))

    p1 = take(xy1, selected.pairs[..., 0])
    p2 = take(xy2, selected.pairs[..., 1])
    m = selected.valid[..., None]
    zero = torch.zeros((), dtype=p1.dtype, device=p1.device)
    return torch.where(m, p1, zero), torch.where(m, p2, zero)
