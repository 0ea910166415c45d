"""What the loop checks (``checks/loop_*.py``, ``checks/pose_graph_gap.py``)
share: the sample of loops they judge, the reference's features and
matches of a loop's two keyframes, the recount of a loop edge's inliers,
and the same loop stages computed by the reference in a lower precision,
which stand in the program's place in the checks' control.

A loop record (``run_visual_slam``'s summary, ``loop_records``, of the
judged pass) names its ``candidate`` (the older keyframe, a) and its
``query`` (b), frames of the route; its pair's matches are the
candidate's features against the query's, the best 256 by distance. An accepted loop carries the pair's (R, t) with
X_b = R X_a + t and unit t, the inliers the program stated under its
RANSAC threshold (``threshold_px``), the nodes and weight of its edge and
the keyframe poses into and out of the pose-graph solve. Plain PyTorch;
nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import features as ref_features
from portbench.reference import geometry, pose_graph

MATCHES = 256  # the loop pair's best matches
HYPOTHESES = 256  # the loop pair's RANSAC hypotheses


def sample(ctx, accepted: bool):
    """Up to the traffic's ``loops`` records, drawn from the seed: of the
    accepted loops (``answers.accepted``), or of every loop the judged pass
    detected (``answers.detected``)."""
    answers = ctx["answers"]
    records = answers.accepted if accepted else answers.detected
    if not records:
        return []
    judge = ctx["judge"]
    rng = np.random.default_rng(np.random.SeedSequence([judge.seed, 0x100F, int(accepted)]))
    k = min(int(ctx["cell"].traffic["judge"]["loops"]), len(records))
    return [records[i] for i in sorted(rng.choice(len(records), size=k, replace=False).tolist())]


def features(judge, frame: int, dtype=torch.float32):
    """The reference's features of a frame (xy, valid, bits), computed in
    ``dtype``, once a run (kept on the run's judge)."""
    caches = judge.__dict__.setdefault("loop_features", {})
    if dtype not in caches:
        caches[dtype] = ({}, ref_features.FrontEnd(judge.feature_cfg, judge.device, dtype))
    cache, front = caches[dtype]
    if frame not in cache:
        cache[frame] = front.features(judge.image(frame))
    return cache[frame]


def matches(judge, record, dtype=torch.float32):
    """The reference's best matches of the loop's candidate against its
    query: pairs (K, 2) and the matched pixels of each."""
    a, b = features(judge, record["candidate"], dtype), features(judge, record["query"], dtype)
    pairs, _ = ref_features.match(a[2], a[1], b[2], b[1], MATCHES)
    return pairs, a[0][pairs[:, 0]], b[0][pairs[:, 1]]


def inliers_under(judge, R, t, p1, p2, threshold_px: float, dtype=torch.float64) -> int:
    """Matches whose Sampson distance under E = [t]x R lies under the
    threshold (pixels over fx); a pose with no translation supports none."""
    if len(p1) == 0 or float(np.linalg.norm(np.asarray(t, np.float64))) < 1e-9:
        return 0
    n1 = geometry._round(geometry.normalise(p1.to(torch.float64), judge.K), dtype)
    n2 = geometry._round(geometry.normalise(p2.to(torch.float64), judge.K), dtype)
    R = torch.as_tensor(np.asarray(R), dtype=torch.float64, device=n1.device)
    t = torch.as_tensor(np.asarray(t), dtype=torch.float64, device=n1.device)
    cut = threshold_px / float(judge.K[0][0])
    return int((geometry.pose_sampson_sq(R, t, n1, n2) < cut * cut).sum())


def recount_gap(judge, record) -> float:
    """|stated inliers - recount| / stated, the recount under the record's
    own (R, t) among the reference's matches of its pair."""
    _, p1, p2 = matches(judge, record)
    got = inliers_under(judge, record["R"], record["t"], p1, p2, record["threshold_px"])
    stated = int(record["num_inliers"])
    judge.details.append({"check": "loop_recount_gap", "query": record["query"], "candidate": record["candidate"], "stated": stated, "recount": got})
    return abs(stated - got) / max(stated, 1)


def control_edge(judge, record, dtype=torch.bfloat16) -> dict:
    """The loop pair's edge as the reference computes it in ``dtype``:
    its features, matches, RANSAC and the inliers it states under its own
    pose; the record's threshold."""
    _, p1, p2 = matches(judge, record, dtype)
    seed = int(np.random.SeedSequence([judge.seed, 0x100F, record["query"]]).generate_state(1)[0])
    gen = torch.Generator(device=judge.device).manual_seed(seed)
    out = geometry.relative_pose(p1, p2, judge.K, record["threshold_px"], gen, hypotheses=HYPOTHESES, dtype=dtype)
    R, t = (np.eye(3), np.zeros(3)) if out is None else (out[0].cpu().numpy(), out[1].cpu().numpy())
    stated = inliers_under(judge, R, t, p1, p2, record["threshold_px"], dtype)
    return dict(record, R=R, t=t, num_inliers=stated)


def median_or_nan(values) -> float:
    return float(np.median(values)) if values else math.nan


def pose_graph_gap(judge, record, corrected) -> float:
    """The largest distance between ``corrected`` keyframe positions and the
    float64 reference's solve from the record's input poses and loop edge,
    in median odometry steps of the input chain."""
    cache = judge.__dict__.setdefault("loop_reference_solves", {})
    key = (record["query"], record["candidate"])
    before = np.asarray(record["poses_before"], np.float64)
    if key not in cache:
        cache[key] = pose_graph.solve_chain(before, record["nodes"], record["rel"], record["weight"], device=judge.device)
    step = float(np.median(np.linalg.norm(np.diff(before[:, :3, 3], axis=0), axis=1)))
    gap = float(np.linalg.norm(np.asarray(corrected)[:, :3, 3] - cache[key][:, :3, 3], axis=1).max()) / max(step, 1e-12)
    judge.details.append({"check": "pose_graph_gap", "query": record["query"], "nodes": len(before), "gap": gap})
    return gap


def control_corrected(judge, record, dtype=torch.bfloat16):
    """The reference's solve in ``dtype``, in the program's place."""
    return pose_graph.solve_chain(record["poses_before"], record["nodes"], record["rel"], record["weight"], device=judge.device, dtype=dtype)
