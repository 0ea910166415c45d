"""Bag-of-words place recognition as dense matrix products.

Port of ``mvslam_tpu/loopclosure/bow.py``: binary descriptors are unpacked
to 0/1 bit vectors; the vocabulary is trained with Lloyd iterations whose
E-step distance matrix ``|x|² + |c|² − 2x·c`` is one product per iteration
and whose M-step is a per-cluster sum. Histogram assignment and cosine
retrieval over the whole database are single products too.

Numerics kept from the reference:

- ``x`` and the centroids are rounded to bfloat16 for the product, which
  accumulates and returns float32. A bf16 × bf16 ``matmul`` in PyTorch
  returns bf16 and would round every dot to 8 bits, so both operands are
  rounded to bf16 and multiplied as float32: the products are exact and
  only the order of the summation differs from the reference's.
- The M-step and the histogram sum 0/1 values, exact in float32 in any
  order; they are one-hot products (no float atomics), so two runs on one
  device are bit-equal.
- ``argmin`` takes the first minimum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from mvslam_tpu_torch.core import prng
from mvslam_tpu_torch.ops.brief import descriptor_words, unpack_bits
from mvslam_tpu_torch.ops.fast import topk_stable


@dataclass(frozen=True)
class BoWConfig:
    """Same fields and defaults as the reference's config."""

    vocab_size: int = 256
    kmeans_iterations: int = 15
    similarity_threshold: float = 0.75
    min_frame_gap: int = 30
    min_train_descriptors_factor: int = 10
    # > 0: keep histograms in a device-resident index
    # (``loopclosure.device_index.DeviceBoWIndex``, initial capacity =
    # this value, doubling when full) and rank queries with one matvec +
    # top-k on the device instead of a host matvec. 0 = host ranking.
    device_index_capacity: int = 0


def _bf16_dots(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``x·cᵀ`` with both operands rounded to bfloat16, accumulated and
    returned in float32."""
    return x.to(torch.bfloat16).to(torch.float32) @ c.to(torch.bfloat16).to(torch.float32).T


def _assign(x: torch.Tensor, x_sq: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row of ``x`` (first minimum on ties)."""
    c_sq = torch.sum(centroids * centroids, dim=1)
    d = x_sq[:, None] + c_sq[None, :] - 2.0 * _bf16_dots(x, centroids)
    return torch.argmin(d, dim=1)


def _one_hot(assign: torch.Tensor, num: int) -> torch.Tensor:
    return (assign[:, None] == torch.arange(num, device=assign.device)).to(torch.float32)


def _lloyd(bits: torch.Tensor, key: torch.Tensor, vocab_size: int, iterations: int) -> torch.Tensor:
    """K-means over (N, 256) bit vectors; returns (vocab_size, 256) f32."""
    n = bits.shape[0]
    x = bits.to(torch.float32)
    # Deterministic distinct init via Gumbel top-k over all rows.
    g = prng.gumbel(key.to(bits.device), (n,))
    centroids = x[topk_stable(g, vocab_size)[1]]
    x_sq = torch.sum(x * x, dim=1)
    for _ in range(iterations):
        onehot = _one_hot(_assign(x, x_sq, centroids), vocab_size)
        sums = onehot.T @ x
        counts = onehot.sum(dim=0)
        new = sums / counts[:, None].clamp_min(1.0)
        # Empty clusters keep their previous centroid.
        centroids = torch.where(counts[:, None] > 0.5, new, centroids)
    return centroids


def train_vocabulary(
    descriptors: np.ndarray, key, vocab_size: int = 256, iterations: int = 15, device="cuda"
) -> np.ndarray:
    """Train a visual vocabulary from packed (N, 8) uint32 descriptors."""
    bits = unpack_bits(descriptor_words(descriptors, device))
    n = bits.shape[0]
    if n < vocab_size:
        raise ValueError(f"need >= {vocab_size} descriptors, got {n}")
    return _lloyd(bits, key, vocab_size, iterations).cpu().numpy()


def assign_histogram(bits: torch.Tensor, valid: torch.Tensor, vocabulary: torch.Tensor) -> torch.Tensor:
    """Normalised word histogram of one frame's descriptors (masked)."""
    x = bits.to(torch.float32)
    assign = _assign(x, torch.sum(x * x, dim=1), vocabulary)
    hist = valid.to(torch.float32) @ _one_hot(assign, vocabulary.shape[0])
    norm = torch.linalg.norm(hist)
    return hist / torch.where(norm < 1e-12, torch.ones_like(norm), norm)


def compute_bow_histogram(descriptors: np.ndarray, valid: np.ndarray, vocabulary: np.ndarray, device="cuda") -> np.ndarray:
    """Host-friendly histogram API: numpy in, numpy out, computed on
    ``device``."""
    bits = unpack_bits(descriptor_words(descriptors, device))
    vocabulary = torch.tensor(np.asarray(vocabulary, np.float32), device=device)  # a copy: the array may be read-only
    valid = torch.as_tensor(np.asarray(valid, bool), device=device)
    return assign_histogram(bits, valid, vocabulary).cpu().numpy()


class BoWDatabase:
    """Online loop detection database on ``device``: frames accumulate; the
    vocabulary is trained once enough descriptors were seen; similarity
    ranking is a cosine product against all stored histograms with a
    deterministic (score, -frame_id) tiebreak."""

    def __init__(self, config: Optional[BoWConfig] = None, key=None, device="cuda") -> None:
        self.config = config or BoWConfig()
        self.device = torch.device(device)
        self._key = key if key is not None else prng.key(0)
        self.vocabulary: Optional[np.ndarray] = None
        self._pending: List[Tuple[int, np.ndarray, np.ndarray]] = []
        self.frame_ids: List[int] = []
        self.histograms: List[np.ndarray] = []
        self._device_index = None
        if self.config.device_index_capacity > 0:
            from mvslam_tpu_torch.loopclosure.device_index import DeviceBoWIndex

            self._device_index = DeviceBoWIndex(
                self.config.vocab_size, self.config.device_index_capacity, device=self.device
            )

    def _histogram(self, descriptors: np.ndarray, valid: np.ndarray) -> np.ndarray:
        return compute_bow_histogram(descriptors, valid, self.vocabulary, device=self.device)

    def _maybe_train(self) -> None:
        if self.vocabulary is not None:
            return
        total = sum(int(v.sum()) for _, _, v in self._pending)
        if total < self.config.vocab_size * self.config.min_train_descriptors_factor:
            return
        desc = np.concatenate(
            [d[v] for _, d, v in self._pending if v.any()], axis=0
        )
        self.vocabulary = train_vocabulary(
            desc, self._key, self.config.vocab_size, self.config.kmeans_iterations, device=self.device
        )
        for fid, d, v in self._pending:
            self._record(fid, self._histogram(d, v))
        self._pending.clear()

    def _record(self, frame_id: int, hist: np.ndarray) -> None:
        self.frame_ids.append(int(frame_id))
        self.histograms.append(hist)
        if self._device_index is not None:
            self._device_index.add(frame_id, hist)

    @staticmethod
    def _as_valid(descriptors, valid) -> np.ndarray:
        return np.ones(len(descriptors), bool) if valid is None else np.asarray(valid, bool)

    def add_frame(self, frame_id: int, descriptors: np.ndarray, valid: Optional[np.ndarray] = None) -> None:
        descriptors = np.asarray(descriptors, dtype=np.uint32)
        valid = self._as_valid(descriptors, valid)
        if self.vocabulary is None:
            self._pending.append((int(frame_id), descriptors, valid))
            self._maybe_train()
        else:
            self._record(frame_id, self._histogram(descriptors, valid))

    @property
    def is_trained(self) -> bool:
        return self.vocabulary is not None

    def rank(self, descriptors: np.ndarray, valid: Optional[np.ndarray] = None) -> List[Tuple[int, float]]:
        """(frame_id, cosine score) sorted by (-score, frame_id)."""
        if self.vocabulary is None or not self.histograms:
            return []
        hist = self._histogram(np.asarray(descriptors, np.uint32), self._as_valid(descriptors, valid))
        return self._rank_from_hist(hist)

    def _rank_from_hist(self, hist: np.ndarray) -> List[Tuple[int, float]]:
        if not self.histograms:
            return []
        if self._device_index is not None:
            # Device matvec; one (F,) fetch. The host path below computes
            # the same scores on the host.
            scores = self._device_index.scores(hist)
        else:
            scores = np.stack(self.histograms) @ hist
        order = sorted(range(len(scores)), key=lambda i: (-float(scores[i]), self.frame_ids[i]))
        return [(self.frame_ids[i], float(scores[i])) for i in order]

    def process_keyframe(
        self, frame_id: int, descriptors: np.ndarray, valid: Optional[np.ndarray] = None
    ) -> Optional[Tuple[int, float]]:
        """Query-then-add with ONE histogram computation: histogram once,
        query (the frame is not yet in the database, so it cannot match
        itself), then record. The per-keyframe entry point of the offline
        pipeline."""
        descriptors = np.asarray(descriptors, dtype=np.uint32)
        valid = self._as_valid(descriptors, valid)
        if self.vocabulary is None:
            self._pending.append((int(frame_id), descriptors, valid))
            self._maybe_train()
            return None
        hist = self._histogram(descriptors, valid)
        hit = self._detect_from_hist(frame_id, hist)
        self._record(frame_id, hist)
        return hit

    def detect_loop(self, frame_id: int, descriptors: np.ndarray, valid: Optional[np.ndarray] = None) -> Optional[Tuple[int, float]]:
        """Best candidate above threshold outside the temporal window."""
        if self.vocabulary is None:
            return None
        hist = self._histogram(np.asarray(descriptors, np.uint32), self._as_valid(descriptors, valid))
        return self._detect_from_hist(frame_id, hist)

    def _detect_from_hist(self, frame_id: int, hist: np.ndarray) -> Optional[Tuple[int, float]]:
        if self._device_index is not None and len(self.frame_ids) > 0:
            # Fast path: top-k on the device, only 2k scalars leave it.
            # Falls back to the full ranking when every fetched candidate
            # is temporally excluded but more frames exist.
            k = min(16, len(self.frame_ids))
            top = self._device_index.topk(hist, k=k)
            for cand_id, score in top:
                if abs(frame_id - cand_id) < self.config.min_frame_gap:
                    continue
                if score >= self.config.similarity_threshold:
                    return cand_id, score
                return None  # ranked: first eligible is the best
            if k >= len(self.frame_ids):
                return None  # exhausted the whole database
            # else: all top-k temporally excluded — fall through to full rank
        for cand_id, score in self._rank_from_hist(hist):
            if abs(frame_id - cand_id) < self.config.min_frame_gap:
                continue
            if score >= self.config.similarity_threshold:
                return cand_id, score
            break  # ranked: first eligible is the best
        return None

    def export_vocabulary(self) -> Optional[np.ndarray]:
        return None if self.vocabulary is None else self.vocabulary.copy()
