"""Mean feature latency of the feature control plane (a frame's wait plus
its batched extraction), in ms, from the window's report."""


def read(ctx):
    report = ctx.get("control_plane")
    if not report:
        return None
    latency = report["snapshots"]["feature"]["latency"]
    return 1e3 * latency["mean"] if latency.get("count") else None
