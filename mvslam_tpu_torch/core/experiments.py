"""Run-directory factory and resolved-config recording.

Counterpart of the reference's ``experiment_registry.py:23-61``: each run
gets a ``{run_id}_{timestamp}`` directory with ``run_metadata.json`` and an
optional ``resolved_config.json`` capturing the exact configuration after
all defaulting, so any artifact can be traced back to its inputs.

Copied close to verbatim from ``mvslam_tpu/core/experiments.py``: it needs numpy only.
"""

from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping, Optional

_SAFE_RUN_ID = re.compile(r"[^A-Za-z0-9._-]+")


@dataclass(frozen=True)
class RunArtifacts:
    run_id: str
    run_dir: Path
    metadata_path: Path


def sanitize_run_id(run_id: str) -> str:
    cleaned = _SAFE_RUN_ID.sub("_", run_id.strip()) or "run"
    return cleaned[:128]


def create_run_artifacts(
    root: Path,
    run_id: str,
    metadata: Optional[Mapping[str, Any]] = None,
    timestamp: Optional[float] = None,
) -> RunArtifacts:
    """Create ``{root}/{run_id}_{utc-stamp}/`` with run_metadata.json.

    Parity: ``experiment_registry.py:23-53``.
    """
    root = Path(root)
    safe_id = sanitize_run_id(run_id)
    ts = time.time() if timestamp is None else timestamp
    stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime(ts))
    run_dir = root / f"{safe_id}_{stamp}"
    suffix = 0
    while run_dir.exists():
        suffix += 1
        run_dir = root / f"{safe_id}_{stamp}_{suffix}"
    run_dir.mkdir(parents=True)
    payload = {
        "run_id": safe_id,
        "created_at": ts,
        "created_at_utc": stamp,
        **dict(metadata or {}),
    }
    metadata_path = run_dir / "run_metadata.json"
    metadata_path.write_text(json.dumps(payload, indent=2, sort_keys=True))
    return RunArtifacts(run_id=safe_id, run_dir=run_dir, metadata_path=metadata_path)


def write_resolved_config(run_dir: Path, config: Mapping[str, Any]) -> Path:
    """Persist the fully-resolved config next to the run's artifacts.

    Parity: ``experiment_registry.py:56-61``.
    """
    path = Path(run_dir) / "resolved_config.json"
    path.write_text(json.dumps(dict(config), indent=2, sort_keys=True, default=str))
    return path
