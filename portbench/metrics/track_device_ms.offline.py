"""Device time of the tracked stretch per frame posed in it, in ms: every
kernel, copy and fill the profiler saw, summed."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.frames or not t.ops:
        return None
    return 1e3 * t.device_seconds() / t.frames
