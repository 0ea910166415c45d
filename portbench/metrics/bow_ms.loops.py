"""Mean ``bow_keyframe`` span (a keyframe's BoW histogram, its query and
its insertion), in ms, over the window outside its traced stretch."""


def read(ctx):
    spans = [e - s for n, s, e in ctx["spans"] if n == "bow_keyframe"]
    return 1e3 * sum(spans) / len(spans) if spans else None
