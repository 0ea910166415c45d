"""Shared helpers for the PyTorch-port parity tests (``test_torch_*.py``).

Importing this module caps torch at one intra-op thread: the suite runs
under several xdist workers, each already a process of its own.
"""

import numpy as np
import torch

torch.set_num_threads(1)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def t(a, dtype=None) -> torch.Tensor:
    """numpy (or JAX) array → torch tensor on the CPU (a copy)."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def desc_u32(desc: torch.Tensor) -> np.ndarray:
    """The port's int32 descriptor words as the reference's uint32 words."""
    return to_np(desc.contiguous()).view(np.uint32)


def textured_image(h=96, w=160, seed=0, n_blobs=40) -> np.ndarray:
    """Random bright square blobs on a dark background: strong corners."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 30, size=(h, w)).astype(np.float32)
    for _ in range(n_blobs):
        y = rng.integers(20, h - 20)
        x = rng.integers(20, w - 20)
        s = rng.integers(3, 7)
        img[y : y + s, x : x + s] = rng.uniform(150, 255)
    return img


def sliding_frames(num_frames, h=128, w=192, shift=6, seed=0) -> np.ndarray:
    """(num_frames, h, w) uint8 views of one textured strip, each ``shift``
    pixels right of the last (the bench's frame model at a small size)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 40, size=(h, w + shift * num_frames)).astype(np.float32)
    for _ in range(150):
        y = rng.integers(20, h - 28)
        x = rng.integers(20, base.shape[1] - 28)
        s = rng.integers(3, 9)
        base[y : y + s, x : x + s] = rng.uniform(120, 255)
    return np.stack([base[:, i * shift : i * shift + w] for i in range(num_frames)]).astype(np.uint8)


def random_descriptors(n, seed=0, duplicate_every=0) -> np.ndarray:
    """(n, 8) uint32 descriptor words; every ``duplicate_every``-th row
    repeats its predecessor, to build exact distance ties."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    if duplicate_every:
        rows = np.arange(duplicate_every, n, duplicate_every)
        d[rows] = d[rows - 1]
    return d


def to_port_keyframes(keyframes):
    """The JAX package's ``MapKeyframe``/``Keyframe`` objects as the port's
    ``MapKeyframe``, through plain numpy copies of their arrays."""
    from mvslam_tpu_torch.loopclosure.persistent_map import MapKeyframe

    return [
        MapKeyframe(
            frame_id=int(kf.frame_id),
            pose=np.array(kf.pose, dtype=np.float64),
            keypoints=np.array(kf.keypoints, dtype=np.float32),
            descriptors=np.array(kf.descriptors, dtype=np.uint32),
            valid=np.array(kf.valid, dtype=bool),
        )
        for kf in keyframes
    ]


def to_port_snapshot(snapshot):
    """The JAX package's ``PersistentMapSnapshot`` as the port's: the same
    keyframes, vocabulary, histograms and frame ids, so both packages
    relocalize against one map (and compute one digest)."""
    from mvslam_tpu_torch.loopclosure.persistent_map import PersistentMapSnapshot

    return PersistentMapSnapshot(
        keyframes=to_port_keyframes(snapshot.keyframes),
        vocabulary=np.array(snapshot.vocabulary),
        histograms=np.array(snapshot.histograms),
        frame_ids=np.array(snapshot.frame_ids),
        schema_version=int(snapshot.schema_version),
        metadata=dict(snapshot.metadata),
    )
