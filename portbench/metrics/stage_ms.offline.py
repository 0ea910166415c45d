"""Host time staging the frames of a dispatch per frame tracked, in ms:
the ``dispatch_stage`` spans (pulling, stacking, padding and uploading
each dispatch's frames) summed over the frames (``frame_process`` spans)
of the window outside its traced stretch."""


def read(ctx):
    spans = ctx["spans"]
    staged = [e - s for n, s, e in spans if n == "dispatch_stage"]
    frames = sum(1 for n, _, _ in spans if n == "frame_process")
    return 1e3 * sum(staged) / frames if staged and frames else None
