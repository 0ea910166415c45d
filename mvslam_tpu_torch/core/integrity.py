"""Stable hashing of arbitrary payloads and event streams.

Counterpart of the reference's ``deterministic_integrity.py:14-65``: any
payload (dataclasses, numpy arrays and tensors, Paths, nested containers) is
normalised into a canonical JSON form — sorted keys, arrays expanded to
nested lists with dtype tags, floats canonicalised — and SHA-256 hashed.
Event-stream digests exclude wall-clock fields so that identical logical
streams produced at different times digest identically.

Copied close to verbatim from ``mvslam_tpu/core/integrity.py``: it needs numpy only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from pathlib import Path
from typing import Any, Iterable, Mapping, Optional, Sequence

import numpy as np

DEFAULT_EVENT_EXCLUDE = ("timestamp_s", "timestamp", "recorded_at")


def _normalize(payload: Any, exclude_keys: frozenset) -> Any:
    if payload is None or isinstance(payload, (bool, int, str)):
        return payload
    if isinstance(payload, float):
        if math.isnan(payload):
            return "__nan__"
        if math.isinf(payload):
            return "__inf__" if payload > 0 else "__-inf__"
        return float(repr(payload)) if payload == payload else payload
    if isinstance(payload, bytes):
        return {"__bytes__": hashlib.sha256(payload).hexdigest()}
    if isinstance(payload, Path):
        return str(payload)
    if dataclasses.is_dataclass(payload) and not isinstance(payload, type):
        return _normalize(dataclasses.asdict(payload), exclude_keys)
    if isinstance(payload, Mapping):
        return {
            str(k): _normalize(v, exclude_keys)
            for k, v in sorted(payload.items(), key=lambda kv: str(kv[0]))
            if str(k) not in exclude_keys
        }
    if isinstance(payload, np.ndarray):
        return {
            "__ndarray__": True,
            "dtype": str(payload.dtype),
            "shape": list(payload.shape),
            "data": payload.tolist(),
        }
    if isinstance(payload, (np.integer,)):
        return int(payload)
    if isinstance(payload, (np.floating,)):
        return _normalize(float(payload), exclude_keys)
    if isinstance(payload, (np.bool_,)):
        return bool(payload)
    if isinstance(payload, (list, tuple, set, frozenset)):
        items = sorted(payload, key=repr) if isinstance(payload, (set, frozenset)) else payload
        return [_normalize(item, exclude_keys) for item in items]
    # CPU tensors and anything array-like: round-trip through numpy.
    if hasattr(payload, "__array__"):
        return _normalize(np.asarray(payload), exclude_keys)
    if hasattr(payload, "__dict__"):
        return _normalize(vars(payload), exclude_keys)
    return repr(payload)


def stable_hash(payload: Any, exclude_keys: Optional[Iterable[str]] = None) -> str:
    """SHA-256 hex digest of a canonical JSON rendering of ``payload``.

    Parity: ``deterministic_integrity.py:14-20``.
    """
    excluded = frozenset(exclude_keys or ())
    normalized = _normalize(payload, excluded)
    encoded = json.dumps(normalized, sort_keys=True, separators=(",", ":")).encode("utf-8")
    return hashlib.sha256(encoded).hexdigest()


def stable_event_digest(
    events: Sequence[Any],
    exclude_keys: Iterable[str] = DEFAULT_EVENT_EXCLUDE,
) -> str:
    """Digest of an ordered event stream excluding wall-clock fields.

    Parity: ``deterministic_integrity.py:23-31``.
    """
    return stable_hash(list(events), exclude_keys=exclude_keys)
