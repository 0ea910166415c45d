"""Host time of window BA's track chaining, triangulation and
reprojection gate per bundle adjustment, in ms: the ``ba_tracks`` spans
summed over the ``local_ba`` spans of the window outside its traced
stretch."""


def read(ctx):
    spans = ctx["spans"]
    tracks = [e - s for n, s, e in spans if n == "ba_tracks"]
    runs = sum(1 for n, _, _ in spans if n == "local_ba")
    return 1e3 * sum(tracks) / runs if tracks and runs else None
