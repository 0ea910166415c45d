"""Loops whose pair's matches differ from the reference's: of up to the
traffic's ``loops`` detected loops, drawn from the seed, those whose valid
match count, or the candidate's feature in any slot of the best 256 by
distance, differs from the reference's cross-checked matching and best-256
selection of the same two keyframes, each from its own frame (exact: limit
0). The count alone is 256 on nearly every pair, so the slots are compared
too. NaN where the window detected no loop. Control: the reference's
features and matches computed in bfloat16, in the program's place."""

import math

import torch

from portbench.reference import loops


def _off(ctx, own) -> float:
    records = loops.sample(ctx, accepted=False)
    if not records:
        return math.nan
    judge = ctx["judge"]
    off = 0
    for r in records:
        pairs, _, _ = loops.matches(judge, r)
        count, idx_a = own(r)
        ref_a = pairs[:, 0].cpu().numpy()
        same = count == len(ref_a) and (idx_a[:count] == ref_a).all()
        off += int(not same)
        judge.details.append({"check": "loop_matches_off", "query": r["query"], "candidate": r["candidate"], "count": count, "reference": len(ref_a), "same": bool(same)})
    return float(off)


def judge(ctx):
    return _off(ctx, lambda r: (int(r["num_valid"]), r["idx_a"]))


def control(ctx):
    def own(r):
        pairs, _, _ = loops.matches(ctx["judge"], r, torch.bfloat16)
        return len(pairs), pairs[:, 0].cpu().numpy()

    return _off(ctx, own)
