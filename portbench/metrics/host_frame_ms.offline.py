"""Mean host time of a frame's bookkeeping in ``SLAMSystem`` (gates, pose
chain, keyframes), in ms: each ``frame_process`` span less the
``local_ba`` spans inside it. Spans of the window outside its traced
stretch."""


def read(ctx):
    spans = ctx["spans"]
    frames = [s for s in spans if s[0] == "frame_process"]
    if not frames:
        return None
    ba = sorted((s, e) for n, s, e in spans if n == "local_ba")
    total = 0.0
    for _, s, e in frames:
        total += (e - s) - sum(be - bs for bs, be in ba if bs >= s and be <= e)
    return 1e3 * total / len(frames)
