"""Time of window BA's Schur LM solve, to its one fetch, per bundle
adjustment, in ms: the ``ba_solve`` spans summed over the ``local_ba``
spans of the window outside its traced stretch."""


def read(ctx):
    spans = ctx["spans"]
    solves = [e - s for n, s, e in spans if n == "ba_solve"]
    runs = sum(1 for n, _, _ in spans if n == "local_ba")
    return 1e3 * sum(solves) / runs if solves and runs else None
