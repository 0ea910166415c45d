"""Device time of matching, selecting and gathering the matched points
per frame tracked, in ms: the ``match.device`` spans (one per window,
from its first device work to its last, waits for the host's launches
included) summed over the frames (``frame_process`` spans) of the window
outside its traced stretch."""


def read(ctx):
    spans = ctx["spans"]
    device = [e - s for n, s, e in spans if n == "match.device"]
    frames = sum(1 for n, _, _ in spans if n == "frame_process")
    return 1e3 * sum(device) / frames if device and frames else None
