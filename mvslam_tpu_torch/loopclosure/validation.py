"""Offline loop-closure verification suite.

Parity: reference ``loop_closure_validation.py`` — per-sample scoring
(geometric component from inlier ratio / reprojection error / match count /
rotation / translation errors, ref L276-295; temporal component, ref
L298-311; weighted 0.7/0.3 combination, ref L314-321), hard thresholds
producing rejection reasons (ref L221-253), and TP/FP/TN/FN
classification with a precision/recall report carrying a stable digest
(ref L152-210).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from mvslam_tpu_torch.core.integrity import stable_hash


@dataclass(frozen=True)
class LoopClosureVerificationThresholds:
    """Parity: ``loop_closure_validation.py:14-54``."""

    min_inlier_ratio: float = 0.4
    max_reprojection_error_px: float = 3.0
    min_match_count: int = 30
    max_rotation_error_deg: float = 10.0
    max_translation_error: float = 1.0
    min_temporal_gap: int = 30
    min_combined_score: float = 0.5
    geometric_weight: float = 0.7
    temporal_weight: float = 0.3


@dataclass
class LoopClosureSample:
    """One candidate loop closure with its measured quality signals."""

    query_frame: int
    candidate_frame: int
    inlier_ratio: float
    reprojection_error_px: float
    match_count: int
    rotation_error_deg: float
    translation_error: float
    is_true_loop: Optional[bool] = None  # ground truth when available


@dataclass
class SampleVerdict:
    accepted: bool
    combined_score: float
    geometric_score: float
    temporal_score: float
    rejection_reasons: List[str] = field(default_factory=list)


def score_loop_closure_sample(
    sample: LoopClosureSample,
    thresholds: LoopClosureVerificationThresholds = LoopClosureVerificationThresholds(),
) -> SampleVerdict:
    """Parity: ``loop_closure_validation.py:213-273``."""
    t = thresholds
    reasons: List[str] = []
    if sample.inlier_ratio < t.min_inlier_ratio:
        reasons.append(f"inlier_ratio {sample.inlier_ratio:.3f} < {t.min_inlier_ratio}")
    if sample.reprojection_error_px > t.max_reprojection_error_px:
        reasons.append(
            f"reprojection_error {sample.reprojection_error_px:.2f}px > {t.max_reprojection_error_px}px"
        )
    if sample.match_count < t.min_match_count:
        reasons.append(f"match_count {sample.match_count} < {t.min_match_count}")
    if sample.rotation_error_deg > t.max_rotation_error_deg:
        reasons.append(
            f"rotation_error {sample.rotation_error_deg:.2f}deg > {t.max_rotation_error_deg}deg"
        )
    if sample.translation_error > t.max_translation_error:
        reasons.append(
            f"translation_error {sample.translation_error:.3f} > {t.max_translation_error}"
        )

    # Geometric score: normalised quality components averaged (ref L276-295).
    def clamp01(v: float) -> float:
        return max(0.0, min(1.0, v))

    components = [
        clamp01(sample.inlier_ratio),
        clamp01(1.0 - sample.reprojection_error_px / max(t.max_reprojection_error_px, 1e-9)),
        clamp01(sample.match_count / max(2 * t.min_match_count, 1)),
        clamp01(1.0 - sample.rotation_error_deg / max(t.max_rotation_error_deg, 1e-9)),
        clamp01(1.0 - sample.translation_error / max(t.max_translation_error, 1e-9)),
    ]
    geometric = sum(components) / len(components)

    # Temporal score: gaps below the minimum score 0 (ref L298-311).
    gap = abs(sample.query_frame - sample.candidate_frame)
    temporal = clamp01((gap - t.min_temporal_gap) / max(t.min_temporal_gap, 1))

    combined = t.geometric_weight * geometric + t.temporal_weight * temporal
    if gap < t.min_temporal_gap:
        reasons.append(f"temporal_gap {gap} < {t.min_temporal_gap}")
    if combined < t.min_combined_score:
        reasons.append(f"combined_score {combined:.3f} < {t.min_combined_score}")
    return SampleVerdict(
        accepted=not reasons,
        combined_score=combined,
        geometric_score=geometric,
        temporal_score=temporal,
        rejection_reasons=reasons,
    )


@dataclass
class LoopClosureValidationReport:
    """Parity: ``loop_closure_validation.py:152-210``."""

    num_samples: int
    accepted: int
    true_positive: int
    false_positive: int
    true_negative: int
    false_negative: int
    precision: float
    recall: float
    verdicts: List[Dict] = field(default_factory=list)
    digest: str = ""

    def to_dict(self) -> Dict:
        return dict(self.__dict__)


def validate_loop_closures(
    samples: List[LoopClosureSample],
    thresholds: LoopClosureVerificationThresholds = LoopClosureVerificationThresholds(),
) -> LoopClosureValidationReport:
    """Score every sample, classify against ground truth when present."""
    tp = fp = tn = fn = accepted = 0
    verdicts: List[Dict] = []
    for sample in samples:
        verdict = score_loop_closure_sample(sample, thresholds)
        if verdict.accepted:
            accepted += 1
        if sample.is_true_loop is not None:
            if verdict.accepted and sample.is_true_loop:
                tp += 1
            elif verdict.accepted and not sample.is_true_loop:
                fp += 1
            elif not verdict.accepted and not sample.is_true_loop:
                tn += 1
            else:
                fn += 1
        verdicts.append(
            {
                "query_frame": sample.query_frame,
                "candidate_frame": sample.candidate_frame,
                "accepted": verdict.accepted,
                "combined_score": verdict.combined_score,
                "geometric_score": verdict.geometric_score,
                "temporal_score": verdict.temporal_score,
                "rejection_reasons": verdict.rejection_reasons,
            }
        )
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    report = LoopClosureValidationReport(
        num_samples=len(samples),
        accepted=accepted,
        true_positive=tp,
        false_positive=fp,
        true_negative=tn,
        false_negative=fn,
        precision=precision,
        recall=recall,
        verdicts=verdicts,
    )
    report.digest = stable_hash(report.to_dict(), exclude_keys=("digest",))
    return report
