"""Share of the traced stretch in which nothing ran on the card, in %:
1 - (union of the device's operation intervals / traced wall)."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
