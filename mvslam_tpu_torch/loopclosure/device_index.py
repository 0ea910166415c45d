"""Device-resident BoW histogram index for place recognition at map scale.

Port of ``mvslam_tpu/loopclosure/device_index.py``. Scoring loop-closure
candidates on the host puts an O(F·V) read on the host memory bus per query
and the whole database in host RAM; at serving scale that is tens of
thousands of keyframes queried every frame.

Here the histogram matrix lives in device memory as a preallocated
``(capacity, V)`` float32 tensor: a query is one (F, V)·(V,) matvec and one
stable top-k on the device, so only 2·k scalars travel device→host. Row
inserts write in place. When the buffer fills, capacity doubles (one
allocation and one copy on the device) instead of failing mid-sequence.
Sharding the capacity axis over several devices is not ported (the
reference's ``mesh`` argument).

Frame ids must be inserted in strictly increasing order (enforced). That
makes the stable top-k's lowest-index tie-break identical to the host
ranking's ``(-score, frame_id)`` order, including for ties that straddle
the k cutoff, so device and host loop detection can never disagree.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import numpy as np
import torch

from mvslam_tpu_torch.ops.fast import topk_stable

logger = logging.getLogger(__name__)


def _topk_scores(buf: torch.Tensor, hist: torch.Tensor, count: int, k: int):
    scores = buf @ hist  # (capacity,)
    # Mask unfilled rows to -inf so they never rank.
    idx = torch.arange(buf.shape[0], device=buf.device)
    scores = torch.where(idx < count, scores, torch.full_like(scores, -float("inf")))
    return topk_stable(scores, k)


class DeviceBoWIndex:
    """Static-capacity, device-resident cosine index over BoW histograms.

    Rows must be L2-normalised histograms (``assign_histogram`` output);
    cosine similarity is then the plain dot product.
    """

    def __init__(self, vocab_size: int, capacity: int, device="cuda") -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.vocab_size = int(vocab_size)
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self._buf = torch.zeros((self.capacity, self.vocab_size), dtype=torch.float32, device=self.device)
        self.frame_ids: List[int] = []

    def __len__(self) -> int:
        return len(self.frame_ids)

    def grow(self, new_capacity: int) -> None:
        """Reallocate to ``new_capacity`` rows (device-side copy)."""
        if new_capacity <= self.capacity:
            return
        new = torch.zeros((int(new_capacity), self.vocab_size), dtype=torch.float32, device=self.device)
        new[: self.capacity] = self._buf
        self._buf = new
        logger.info(
            "device BoW index grown", extra={"from": self.capacity, "to": int(new_capacity)}
        )
        self.capacity = int(new_capacity)

    def add(self, frame_id: int, histogram: np.ndarray) -> None:
        """Insert one L2-normalised histogram row (in-place row write).

        Grows the buffer (doubling) when full instead of failing: a long
        sequence must never crash mid-run on index capacity. Frame ids
        must be strictly increasing (keeps device/host tie-breaks equal).
        """
        frame_id = int(frame_id)
        if self.frame_ids and frame_id <= self.frame_ids[-1]:
            raise ValueError(
                f"frame ids must be strictly increasing (got {frame_id} after "
                f"{self.frame_ids[-1]}); monotone insertion is what makes the "
                "device top-k tie-break match the host (-score, frame_id) order"
            )
        if len(self.frame_ids) >= self.capacity:
            self.grow(self.capacity * 2)
        self._buf[len(self.frame_ids)] = self._row(histogram)
        self.frame_ids.append(frame_id)

    def _row(self, histogram) -> torch.Tensor:
        return torch.as_tensor(np.asarray(histogram, np.float32), device=self.device)

    def topk(self, histogram: np.ndarray, k: int = 5) -> List[Tuple[int, float]]:
        """Best-k (frame_id, cosine score), ties broken by lower frame id.

        Matvec + masked stable top-k on the device; only 2·k scalars are
        fetched, in one copy. Exactness: rows are inserted in frame-id
        order, so the lowest-index tie-break IS the host's
        ``(-score, frame_id)`` order, even for ties across the cutoff.
        """
        if not self.frame_ids:
            return []
        k_eff = min(int(k), self.capacity)
        scores, idx = _topk_scores(self._buf, self._row(histogram), len(self.frame_ids), k_eff)
        # One fetch: float64 holds both the float32 scores and the row ids.
        packed = torch.stack([scores.to(torch.float64), idx.to(torch.float64)]).cpu().numpy()
        out = [
            (self.frame_ids[int(i)], float(s))
            for s, i in zip(packed[0], packed[1])
            if np.isfinite(s)
        ][: len(self.frame_ids)]
        out.sort(key=lambda t: (-t[1], t[0]))
        return out[:k]

    def scores(self, histogram: np.ndarray) -> np.ndarray:
        """Full (len(self),) score vector (for parity tests/diagnostics)."""
        if not self.frame_ids:
            return np.zeros(0, np.float32)
        s = self._buf @ self._row(histogram)
        return s[: len(self.frame_ids)].cpu().numpy()

    @classmethod
    def from_histograms(
        cls,
        frame_ids,
        histograms: np.ndarray,
        capacity: Optional[int] = None,
        device="cuda",
    ) -> "DeviceBoWIndex":
        """Bulk-load a snapshot's histogram matrix (one host→device copy).

        ``frame_ids`` must be strictly increasing (see class docstring).
        """
        ids = [int(f) for f in frame_ids]
        if any(b <= a for a, b in zip(ids, ids[1:])):
            raise ValueError(
                "frame_ids must be strictly increasing for the device index "
                "(sort the snapshot by frame id before bulk-loading)"
            )
        histograms = np.asarray(histograms, np.float32)
        n, vocab = histograms.shape
        cap = int(capacity) if capacity is not None else max(n, 1)
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} histograms")
        index = cls(vocab, cap, device=device)
        index._buf[:n] = torch.from_numpy(np.ascontiguousarray(histograms)).to(index.device)
        index.frame_ids = ids
        return index
