"""Mean ``frame_decode`` span (one PNG file read and decoded on the
reader's loader thread), in ms, over the window outside its traced
stretch. None where the program records no such span."""


def read(ctx):
    spans = [e - s for n, s, e in ctx["spans"] if n == "frame_decode"]
    return 1e3 * sum(spans) / len(spans) if spans else None
