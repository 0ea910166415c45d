"""K2 (32x32 tiles, ``csrc/extract_patches.cu``) against its roofline, in
%, as K1's reader computes it."""

from portbench import roofline


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    shapes = t.launch_shapes.get("k2")
    seen = t.count("extract_patches_kernel")
    if not shapes or not seen:
        return None
    launches = sum(shapes.values())
    device = t.device_seconds("extract_patches_kernel") / seen * launches
    return 100.0 * roofline.least_seconds_of(shapes, roofline.k2_work) / device
