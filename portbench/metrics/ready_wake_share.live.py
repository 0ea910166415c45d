"""Share of the frames the caller's thread tracked on waking for their
ready features, before a newer packet was submitted, as a ratio: the
``ready_wake`` spans over the ``ready_wait`` spans (one a frame tracked) of
the window outside its traced stretch. None where there is no
``ready_wait`` span; 0 from a program that records no ``ready_wake``."""


def read(ctx):
    names = [n for n, _, _ in ctx["spans"]]
    waits = names.count("ready_wait")
    return names.count("ready_wake") / waits if waits else None
