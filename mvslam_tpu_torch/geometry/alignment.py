"""Umeyama similarity alignment (used by ATE and Sim(3) loop scaling).

Port of ``mvslam_tpu/geometry/alignment.py``; follows the input device and
dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch


def umeyama_alignment(
    source: torch.Tensor,
    target: torch.Tensor,
    with_scale: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Least-squares similarity transform aligning source → target.

    source, target: (N, D). Returns (R, t, s) minimising
    ``|| target - (s R source + t) ||²`` with the determinant flip guard.
    """
    n, d = source.shape
    mu_s = source.mean(dim=0)
    mu_t = target.mean(dim=0)
    src_c = source - mu_s
    tgt_c = target - mu_t
    cov = (tgt_c.T @ src_c) / n
    U, D, Vt = torch.linalg.svd(cov)
    det_sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    S = torch.cat([torch.ones(d - 1, dtype=source.dtype, device=source.device), det_sign[None]])
    R = (U * S[None, :]) @ Vt
    if with_scale:
        var_s = (src_c * src_c).sum(dim=1).mean()
        scale = (D * S).sum() / torch.where(var_s < 1e-12, torch.full_like(var_s, 1e-12), var_s)
    else:
        scale = torch.ones((), dtype=source.dtype, device=source.device)
    t = mu_t - scale * (R @ mu_s)
    return R, t, scale


def apply_similarity(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return s * (points @ R.T) + t
