"""How far the program's pose-graph correction lies from the reference's:
over up to the traffic's ``loops`` accepted loops, drawn from the seed,
the largest distance between a keyframe position the program's solve
gave and the float64 reference's solve (``reference/pose_graph.py``) from
the same input poses and loop edge, in median odometry steps of the input
chain. NaN where the window accepted no loop. Control: the reference's
solve in bfloat16 in the program's place."""

import math

import torch

from portbench.reference import loops


def _gap(ctx, corrected) -> float:
    records = loops.sample(ctx, accepted=True)
    if not records:
        return math.nan
    return max(loops.pose_graph_gap(ctx["judge"], r, corrected(r)) for r in records)


def judge(ctx):
    return _gap(ctx, lambda r: r["poses_after"])


def control(ctx):
    return _gap(ctx, lambda r: loops.control_corrected(ctx["judge"], r, torch.bfloat16))
