"""Bit-reproducibility auditor: digest runs, compare, CLI.

Parity: reference ``determinism_validation.py`` — digests every artifact
in a run directory (trajectory npz via stable_hash of arrays, JSON with
volatile fields excluded, telemetry with timestamps/memory excluded, map
arrays via file sha256 — ref L202-322), compares two run directories into
a ``DeterminismReport`` with per-artifact match/mismatch/missing (ref
L116-164), and a CLI exiting 1 on drift (ref L341-350).

Copied close to verbatim from ``mvslam_tpu/eval/determinism_validation.py``: it imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from mvslam_tpu_torch.core.integrity import stable_hash

_VOLATILE_JSON_KEYS = (
    "timestamp_s",
    "timestamp",
    "recorded_at",
    "created_at",
    "created_at_utc",
    "duration_s",
    "memory_delta_bytes",
    "wait_time_s",
)


def _digest_npz(path: Path) -> str:
    with np.load(path, allow_pickle=False) as data:
        payload = {k: np.asarray(data[k]) for k in sorted(data.files)}
    return stable_hash(payload)


def _digest_json(path: Path) -> str:
    return stable_hash(json.loads(path.read_text()), exclude_keys=_VOLATILE_JSON_KEYS)


def _digest_file(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def build_run_digest(run_dir: Path) -> Dict[str, str]:
    """Artifact-relative-path → digest for every artifact in a run dir.

    Parity: ``determinism_validation.py:101-113, 202-322``.
    """
    run_dir = Path(run_dir)
    digests: Dict[str, str] = {}
    for path in sorted(run_dir.rglob("*")):
        if not path.is_file():
            continue
        rel = str(path.relative_to(run_dir))
        if path.suffix == ".npz":
            digests[rel] = _digest_npz(path)
        elif path.suffix == ".json":
            digests[rel] = _digest_json(path)
        else:
            digests[rel] = _digest_file(path)
    return digests


@dataclass
class DeterminismReport:
    """Parity: ``determinism_validation.py:116-164``."""

    matched: List[str] = field(default_factory=list)
    mismatched: List[str] = field(default_factory=list)
    missing_in_a: List[str] = field(default_factory=list)
    missing_in_b: List[str] = field(default_factory=list)

    @property
    def passed(self) -> bool:
        return not (self.mismatched or self.missing_in_a or self.missing_in_b)

    def to_dict(self) -> Dict:
        return {
            "passed": self.passed,
            "matched": self.matched,
            "mismatched": self.mismatched,
            "missing_in_a": self.missing_in_a,
            "missing_in_b": self.missing_in_b,
        }


def compare_run_digests(digests_a: Dict[str, str], digests_b: Dict[str, str]) -> DeterminismReport:
    report = DeterminismReport()
    for key in sorted(set(digests_a) | set(digests_b)):
        if key not in digests_a:
            report.missing_in_a.append(key)
        elif key not in digests_b:
            report.missing_in_b.append(key)
        elif digests_a[key] == digests_b[key]:
            report.matched.append(key)
        else:
            report.mismatched.append(key)
    return report


def build_determinism_report(run_dir_a: Path, run_dir_b: Path) -> DeterminismReport:
    """Parity: ``determinism_validation.py:178-183``."""
    return compare_run_digests(build_run_digest(run_dir_a), build_run_digest(run_dir_b))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description="Compare two run dirs for bit-reproducibility")
    parser.add_argument("run_a", type=Path)
    parser.add_argument("run_b", type=Path)
    parser.add_argument("--json", action="store_true")
    args = parser.parse_args(argv)
    report = build_determinism_report(args.run_a, args.run_b)
    if args.json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(f"determinism: {'PASS' if report.passed else 'FAIL'}")
        for kind in ("mismatched", "missing_in_a", "missing_in_b"):
            for item in getattr(report, kind):
                print(f"  {kind}: {item}")
    return 0 if report.passed else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
