"""Relocalization telemetry summaries.

Parity: reference ``relocalization_metrics.py`` — summaries of
relocalization search events (attempts / successes / latency quantiles,
ref L24-46) and of relocalized frames (match/inlier quantiles, recovery
success rate, frame gap, ref L49-97).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping

import numpy as np


def summarize_relocalization_events(events: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Digest ``relocalization_search`` telemetry events."""
    attempts = 0
    successes = 0
    latencies: List[float] = []
    for event in events:
        if event.get("name") != "relocalization_search":
            continue
        attempts += 1
        meta = event.get("metadata") or {}
        if meta.get("success"):
            successes += 1
        latencies.append(float(event.get("duration_s", 0.0)))
    lat = np.asarray(latencies) if latencies else np.zeros(0)
    return {
        "attempts": attempts,
        "successes": successes,
        "success_rate": successes / max(attempts, 1),
        "latency_p50_s": float(np.quantile(lat, 0.5)) if len(lat) else 0.0,
        "latency_p95_s": float(np.quantile(lat, 0.95)) if len(lat) else 0.0,
    }


def summarize_relocalized_frames(diagnostics: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
    """Digest frame diagnostics for relocalization quality."""
    failures = 0
    relocalized_frames: List[int] = []
    failure_frames: List[int] = []
    matches: List[float] = []
    inliers: List[float] = []
    for record in diagnostics:
        if not record.get("pose_success", True):
            failures += 1
            failure_frames.append(int(record.get("frame_id", -1)))
        if record.get("relocalized"):
            relocalized_frames.append(int(record.get("frame_id", -1)))
            matches.append(float(record.get("num_matches", 0)))
            inliers.append(float(record.get("num_inliers", 0)))
    gaps = []
    for rf in relocalized_frames:
        prior = [f for f in failure_frames if f <= rf]
        if prior:
            gaps.append(rf - prior[-1])
    m = np.asarray(matches) if matches else np.zeros(0)
    i = np.asarray(inliers) if inliers else np.zeros(0)
    return {
        "tracking_failures": failures,
        "relocalizations": len(relocalized_frames),
        "recovery_rate": len(relocalized_frames) / max(failures, 1),
        "matches_p50": float(np.quantile(m, 0.5)) if len(m) else 0.0,
        "inliers_p50": float(np.quantile(i, 0.5)) if len(i) else 0.0,
        "mean_recovery_gap_frames": float(np.mean(gaps)) if gaps else 0.0,
    }
