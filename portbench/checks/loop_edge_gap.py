"""How far an accepted loop's edge lies from the scene's own geometry: over
up to the traffic's ``loops`` accepted loops, drawn from the seed, the
largest distance between the translation of the edge the program passed
to its pose graph (``rel``: the query's pose in the candidate's frame, in
map units) and the rendered route's, each in units of the step from the
candidate to the next keyframe (the program's in its map, the route's in
metres). The program sets the edge's scale by structure transfer through
that step, capped at the odometry chain's distance between the loop's two
keyframes, so a sound edge reads the error of that scale and of its
direction, and a wrong sign, direction or scale about as much as the edge
is long: a wrong scale is seen by neither the recount nor the pose-graph
check, since both sides of each take the edge as given. Nothing the
program computed enters the route's side. NaN where the judged pass
accepted no loop. Control: the reference's loop pair in bfloat16 states
(R, t) in the program's place, with the program's scale."""

import math

import numpy as np
import torch

from portbench import scene
from portbench.reference import loops


def _edge_gap(ctx, edge) -> float:
    records = loops.sample(ctx, accepted=True)
    if not records:
        return math.nan
    route = scene.camera_path(ctx["cell"].config)
    keyframes = sorted(ctx["answers"].keyframes)
    worst = 0.0
    for r in records:
        a, b = int(r["candidate"]), int(r["query"])
        node = int(r["nodes"][0])
        before = np.asarray(r["poses_before"], np.float64)
        if node + 1 >= len(before) or keyframes[node] != a:
            return math.inf  # the record's nodes do not name the pass's keyframes
        step_map = float(np.linalg.norm(before[node + 1, :3, 3] - before[node, :3, 3]))
        step_route = float(np.linalg.norm(route[keyframes[node + 1], :3, 3] - route[a, :3, 3]))
        truth = (np.linalg.inv(route[a]) @ route[b])[:3, 3] / step_route
        gap = float(np.linalg.norm(np.asarray(edge(r), np.float64) / max(step_map, 1e-12) - truth))
        ctx["judge"].details.append({"check": "loop_edge_gap", "query": b, "candidate": a, "gap": gap})
        worst = max(worst, gap)
    return worst


def judge(ctx):
    return _edge_gap(ctx, lambda r: np.asarray(r["rel"])[:3, 3])


def control(ctx):
    def edge(r):
        own = loops.control_edge(ctx["judge"], r, torch.bfloat16)
        return -np.asarray(own["R"]).T @ (np.asarray(own["t"]) * float(r["scale"]))

    return _edge_gap(ctx, edge)
