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
With a ``mesh`` (``core.sharding.Mesh``) the capacity axis is split into
its slots' blocks: each slot holds, scores and top-k's its block on its
device, an insert writes only the owning slot's block, and the per-slot
candidates are merged on slot 0's device by (−score, global row).

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

from mvslam_tpu_torch.core.sharding import Mesh, concat
from mvslam_tpu_torch.ops.fast import topk_stable

logger = logging.getLogger(__name__)


def _topk_scores(buf: torch.Tensor, hist: torch.Tensor, count: int, k: int, offset: int = 0):
    """Stable top-k of one block's scores; rows ``offset + i >= count``
    are unfilled and masked to -inf so they never rank."""
    scores = buf @ hist  # (rows,)
    idx = torch.arange(offset, offset + buf.shape[0], device=buf.device)
    scores = torch.where(idx < count, scores, torch.full_like(scores, -float("inf")))
    return topk_stable(scores, k)


def _round_up(capacity: int, mesh: Optional[Mesh]) -> int:
    if mesh is not None and capacity % mesh.size:
        capacity += mesh.size - capacity % mesh.size
    return int(capacity)


class DeviceBoWIndex:
    """Static-capacity, device-resident cosine index over BoW histograms.

    Rows must be L2-normalised histograms (``assign_histogram`` output);
    cosine similarity is then the plain dot product.

    ``mesh``: optional one-axis :class:`~mvslam_tpu_torch.core.sharding.Mesh`
    whose slots hold contiguous, equal blocks of the capacity axis (the
    capacity is rounded up to a multiple of its size); it replaces
    ``device``. The top-k equals the unsharded index's ranking: each slot's
    candidates come in (−score, row) order and the merge keeps slot order
    among equal scores, so ties that straddle blocks break by global row.
    """

    def __init__(self, vocab_size: int, capacity: int, device="cuda", mesh: Optional[Mesh] = None) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.vocab_size = int(vocab_size)
        self._mesh = mesh
        self.capacity = _round_up(capacity, mesh)
        self.device = torch.device(device) if mesh is None else mesh.devices[0]
        self._blocks = self._zeros(self.capacity)
        self.frame_ids: List[int] = []

    def _slots(self) -> List[torch.device]:
        return [self.device] if self._mesh is None else list(self._mesh.devices)

    def _zeros(self, capacity: int) -> List[torch.Tensor]:
        slots = self._slots()
        rows = capacity // len(slots)
        return [torch.zeros((rows, self.vocab_size), dtype=torch.float32, device=dev) for dev in slots]

    @property
    def _rows(self) -> int:
        """Rows per block."""
        return self._blocks[0].shape[0]

    @property
    def _buf(self) -> torch.Tensor:
        """The whole (capacity, V) matrix (on a mesh: a copy on slot 0's
        device)."""
        return concat(self._blocks, self.device)

    def __len__(self) -> int:
        return len(self.frame_ids)

    def grow(self, new_capacity: int) -> None:
        """Reallocate to ``new_capacity`` rows (device-side copies; on a
        mesh each new block takes its rows from the old blocks that held
        them)."""
        new_capacity = _round_up(new_capacity, self._mesh)
        if new_capacity <= self.capacity:
            return
        new, old_rows = self._zeros(new_capacity), self._rows
        new_rows = new[0].shape[0]
        for s, blk in enumerate(new):
            lo, hi = s * new_rows, (s + 1) * new_rows
            for t, old in enumerate(self._blocks):
                a, b = max(lo, t * old_rows), min(hi, (t + 1) * old_rows)
                if a < b:
                    blk[a - lo : b - lo] = old[a - t * old_rows : b - t * old_rows].to(blk.device)
        self._blocks = new
        logger.info(
            "device BoW index grown", extra={"from": self.capacity, "to": int(new_capacity)}
        )
        self.capacity = int(new_capacity)

    def add(self, frame_id: int, histogram: np.ndarray) -> None:
        """Insert one L2-normalised histogram row (in-place row write into
        the owning slot's block).

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
        slot, row = divmod(len(self.frame_ids), self._rows)
        blk = self._blocks[slot]
        blk[row] = self._row(histogram, blk.device)
        self.frame_ids.append(frame_id)

    def _row(self, histogram, device=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(histogram, np.float32), device=self.device if device is None else device)

    def _placed(self, histogram) -> dict:
        """The query row, copied once to each distinct device of the slots."""
        return {dev: self._row(histogram, dev) for dev in dict.fromkeys(self._slots())}

    def topk(self, histogram: np.ndarray, k: int = 5) -> List[Tuple[int, float]]:
        """Best-k (frame_id, cosine score), ties broken by lower frame id.

        Matvec + masked stable top-k on the device (per slot on a mesh,
        merged on slot 0's device); only 2·k scalars are fetched, in one
        copy. Exactness: rows are inserted in frame-id order, so the
        lowest-index tie-break IS the host's ``(-score, frame_id)`` order,
        even for ties across the cutoff.
        """
        if not self.frame_ids:
            return []
        k_eff = min(int(k), self.capacity)
        count, rows = len(self.frame_ids), self._rows
        if self._mesh is None:
            scores, idx = _topk_scores(self._blocks[0], self._row(histogram), count, k_eff)
        else:
            query = self._placed(histogram)
            cand = [
                _topk_scores(blk, query[blk.device], count, min(k_eff, rows), s * rows)
                for s, blk in enumerate(self._blocks)
            ]
            scores = concat([c[0] for c in cand], self.device)
            idx = concat([c[1] + s * rows for s, c in enumerate(cand)], self.device)
            scores, pos = topk_stable(scores, k_eff)  # equal scores keep slot order: lower global row first
            idx = idx[pos]
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
        query = self._placed(histogram)
        s = concat([blk @ query[blk.device] for blk in self._blocks], self.device)
        return s[: len(self.frame_ids)].cpu().numpy()

    @classmethod
    def from_histograms(
        cls,
        frame_ids,
        histograms: np.ndarray,
        capacity: Optional[int] = None,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ) -> "DeviceBoWIndex":
        """Bulk-load a snapshot's histogram matrix (one host→device copy
        per slot).

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
        cap = _round_up(int(capacity) if capacity is not None else max(n, 1), mesh)
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} histograms")
        index = cls(vocab, cap, device=device, mesh=mesh)
        rows = index._rows
        for s, blk in enumerate(index._blocks):
            part = histograms[s * rows : min(n, (s + 1) * rows)]
            if len(part):
                blk[: len(part)] = torch.from_numpy(np.ascontiguousarray(part)).to(blk.device)
        index.frame_ids = ids
        return index
