"""Host time launching the tracking step per frame tracked, in ms: the
``track_enqueue`` spans (the host enqueue of each dispatch's windows)
summed over the frames (``frame_process`` spans) of the window outside
its traced stretch."""


def read(ctx):
    spans = ctx["spans"]
    enqueued = [e - s for n, s, e in spans if n == "track_enqueue"]
    frames = sum(1 for n, _, _ in spans if n == "frame_process")
    return 1e3 * sum(enqueued) / frames if enqueued and frames else None
