"""Global determinism contract.

Port of ``mvslam_tpu/core/determinism.py``; counterpart of the upstream determinism core
(``deterministic_registry.py:35-103`` in the reference repo): a single seed
is applied to every host RNG, and per-component seeds are derived via a
stable cryptographic fold so that adding/removing components never perturbs
the streams of the others.

On top of that contract this registry also hands out threefry keys
(``key_for``, the raw words of ``jax.random.key`` from ``core.prng``) — the
device-side RNG of the RANSAC hypothesis samplers, so that on-device
sampling is bit-stable across runs and equal to the JAX package's.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

from mvslam_tpu_torch.core import prng

_UINT32_MASK = 0xFFFFFFFF
_INT64_MASK = 0x7FFFFFFFFFFFFFFF


def _fold_seed(seed: int, component: str) -> int:
    """Derive a stable 63-bit sub-seed from ``sha256(f"{seed}:{component}")``."""
    digest = hashlib.sha256(f"{seed}:{component}".encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "big") & _INT64_MASK


def hash_config_path(config_path: Optional[Path]) -> str:
    """SHA-256 hex digest of a config file's bytes ('' if absent)."""
    if config_path is None:
        return ""
    path = Path(config_path)
    if not path.exists():
        return ""
    return hashlib.sha256(path.read_bytes()).hexdigest()


@dataclass(frozen=True)
class DeterminismRegistry:
    """Seed registry applied once per run; all components draw from it.

    Parity: ``deterministic_registry.py:35-78`` (apply_global_seed / seed_for).
    """

    seed: int
    config_hash: str = ""
    _applied: dict = field(default_factory=dict, repr=False, compare=False)

    def apply_global_seed(self) -> None:
        """Seed every host RNG: ``random``, ``numpy``, and cv2 when present."""
        random.seed(self.seed)
        np.random.seed(self.seed & _UINT32_MASK)
        try:  # cv2 is a host-only optional dependency (decode path)
            import cv2

            cv2.setRNGSeed(self.seed & _UINT32_MASK)
        except Exception:
            pass
        self._applied["global"] = True

    def seed_for(self, component: str) -> int:
        """Stable per-component sub-seed (63-bit)."""
        return _fold_seed(self.seed, component)

    def key_for(self, component: str, device=None):
        """A threefry key (``prng.key`` words) derived from the component
        sub-seed, on ``device``.

        Device-side analog of ``seed_for`` — used to drive on-device
        sampling (RANSAC hypotheses) deterministically; bit-equal to the
        JAX package's ``jax.random.key`` for the same seed.
        """
        return prng.key(self.seed_for(component) & _UINT32_MASK, device)

    def rng_for(self, component: str) -> np.random.Generator:
        """A NumPy Generator seeded for one component (host-side sampling)."""
        return np.random.default_rng(self.seed_for(component))

    def metadata(self) -> dict:
        """Determinism payload embedded in every persisted artifact."""
        return {"seed": self.seed, "config_hash": self.config_hash}


def build_registry(seed: int, config_path: Optional[Path] = None) -> DeterminismRegistry:
    """Build a registry binding a run seed to the SHA-256 of its config file.

    Parity: ``deterministic_registry.py:88-103``.
    """
    return DeterminismRegistry(seed=int(seed), config_hash=hash_config_path(config_path))
