"""Mean time a frame waits in the feature plane from its submit to the
start of its batch's extraction, in ms: the ``feature_queue`` spans of
the window outside its traced stretch."""


def read(ctx):
    waits = [e - s for n, s, e in ctx["spans"] if n == "feature_queue"]
    return 1e3 * sum(waits) / len(waits) if waits else None
