"""Share of the window's wall that loop closure takes, as a ratio: the
``bow_keyframe``, ``loop_geometry`` and ``loop_pose_graph`` spans of the
window outside its traced stretch, summed, over the window's seconds.
None where there is no such span."""

LOOP_SPANS = ("bow_keyframe", "loop_geometry", "loop_pose_graph")


def read(ctx):
    spans = [e - s for n, s, e in ctx["spans"] if n in LOOP_SPANS]
    wall = ctx.get("window_s")
    return sum(spans) / wall if spans and wall else None
