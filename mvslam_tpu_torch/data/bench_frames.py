"""The benchmark's synthetic frames (numpy only).

A verbatim copy of ``make_frames`` from the repository's ``bench.py``, so
that the port's smoke test drives the same 1226x370 frames without
importing the reference's benchmark module. Frame ``i`` is a window of one
wide random texture (uniform 0-40 with 1200 bright 3-8 px blocks), slid
``shift`` pixels per frame.
"""

from __future__ import annotations

import numpy as np

H, W = 370, 1226


def make_frames(num_frames: int, shift: int = 6, seed: int = 0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 40, size=(H, W + shift * num_frames)).astype(np.float32)
    for _ in range(1200):
        y = rng.integers(25, H - 32)
        x = rng.integers(25, base.shape[1] - 32)
        s = rng.integers(3, 9)
        base[y : y + s, x : x + s] = rng.uniform(120, 255)
    return [base[:, i * shift : i * shift + W].copy() for i in range(num_frames)]
