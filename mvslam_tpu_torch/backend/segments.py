"""Deterministic segment sums for the back end's normal equations.

The reference assembles with ``jax.ops.segment_sum`` and ``.at[].add``,
deterministic on its devices. Their obvious PyTorch forms (``index_add_``,
``scatter_add_``, ``index_put_`` with ``accumulate=True``) add with float
atomics on CUDA, so the order of the additions, and the last bits of every
sum, change from run to run. Here the members of each segment are listed
once, on the host, in a (segments, width) table padded with the index of an
appended zero row; a sum is one gather and a reduction over the table's
width, whose order is fixed by the shapes: bit-equal run to run on one
device. The segment ids of every assembly in the back end (factor edges,
observation poses and points) are known on the host before the solve.
"""

from __future__ import annotations

import numpy as np
import torch


def segment_table(ids, num_segments: int, device=None, keep=None) -> torch.Tensor:
    """(num_segments, width) int64 table of the positions of each segment's
    members in ``ids``, ascending, padded with ``len(ids)``. Entries where
    ``keep`` is False are left out (padding rows that add exact zeros)."""
    ids = np.asarray(ids, dtype=np.int64).reshape(-1)
    pos = np.arange(len(ids)) if keep is None else np.flatnonzero(np.asarray(keep).reshape(-1))
    sel = ids[pos]
    counts = np.bincount(sel, minlength=num_segments)
    width = max(1, int(counts.max(initial=0)))
    order = np.argsort(sel, kind="stable")
    starts = np.cumsum(counts) - counts
    rank = np.arange(len(sel)) - starts[sel[order]]
    table = np.full((num_segments, width), len(ids), dtype=np.int64)
    table[sel[order], rank] = pos[order]
    return torch.from_numpy(table).to(device)


def segment_sum(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of ``values`` (M, ...) over a :func:`segment_table`
    built from M ids: (num_segments, ...)."""
    padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    return padded[table].sum(dim=1)
