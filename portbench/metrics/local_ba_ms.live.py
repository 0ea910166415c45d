"""Mean ``local_ba`` span (one window bundle adjustment), in ms, over the
window outside its traced stretch."""


def read(ctx):
    ba = [e - s for n, s, e in ctx["spans"] if n == "local_ba"]
    return 1e3 * sum(ba) / len(ba) if ba else None
