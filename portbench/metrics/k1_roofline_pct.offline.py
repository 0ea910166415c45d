"""K1 (FAST-9 + NMS, ``csrc/fast_detect.cu``) against its roofline, in %:
the least time of the launches counted by shape in the traced stretch
(``portbench/roofline.py``) over their device time (the mean of the
launches the profiler recorded, times the launches counted)."""

from portbench import roofline


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    shapes = t.launch_shapes.get("k1")
    seen = t.count("fast_detect_kernel")
    if not shapes or not seen:
        return None
    launches = sum(shapes.values())
    device = t.device_seconds("fast_detect_kernel") / seen * launches
    return 100.0 * roofline.least_seconds_of(shapes, roofline.k1_work) / device
