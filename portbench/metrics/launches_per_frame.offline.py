"""CUDA kernels launched in the traced stretch per frame posed in it."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.frames or not t.kernels:
        return None
    return t.kernels / t.frames
