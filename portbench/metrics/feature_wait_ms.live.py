"""Mean feature latency of the feature control plane, in ms, from the
window's report: the plane's ``latency``, a batch's extraction wall
alone, without the wait before the batch starts."""


def read(ctx):
    report = ctx.get("control_plane")
    if not report:
        return None
    latency = report["snapshots"]["feature"]["latency"]
    return 1e3 * latency["mean"] if latency.get("count") else None
