"""Mean time a frame's features sit ready before the caller's thread
starts tracking it, in ms: the ``ready_wait`` spans of the window outside
its traced stretch."""


def read(ctx):
    waits = [e - s for n, s, e in ctx["spans"] if n == "ready_wait"]
    return 1e3 * sum(waits) / len(waits) if waits else None
