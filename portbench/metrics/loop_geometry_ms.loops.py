"""Mean ``loop_geometry`` span (one detected loop's verification: the
loop pair's and the chain pair's matching, RANSAC, decomposition and
triangulation, their one fetch, and the host's gates), in ms, over the
window outside its traced stretch."""


def read(ctx):
    spans = [e - s for n, s, e in ctx["spans"] if n == "loop_geometry"]
    return 1e3 * sum(spans) / len(spans) if spans else None
