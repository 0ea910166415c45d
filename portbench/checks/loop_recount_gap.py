"""How far a loop edge's stated inliers lie from the reference's recount:
over up to the traffic's ``loops`` accepted loops, drawn from the seed, the
median of |stated - recount| / stated, the recount being the reference's
matches of the loop pair whose Sampson distance under E = [t]x R of the
loop edge's own (R, t) lies under the threshold the program states (2 px).
It holds the loop pair's matching, its RANSAC model and the decomposition
into the edge. NaN where the window accepted no loop. Control: the
reference's features, matches and RANSAC in bfloat16 state the edge and
its inliers in the program's place."""

import torch

from portbench.reference import loops


def judge(ctx):
    return loops.median_or_nan([loops.recount_gap(ctx["judge"], r) for r in loops.sample(ctx, accepted=True)])


def control(ctx):
    j = ctx["judge"]
    return loops.median_or_nan([loops.recount_gap(j, loops.control_edge(j, r, torch.bfloat16)) for r in loops.sample(ctx, accepted=True)])
