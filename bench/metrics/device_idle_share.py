"""The share of the traced window in which no operation ran on the
device: one minus the union of its kernels, copies and sets."""
UNIT = "%"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "scans_per_s"


def read(ctx):
    t = ctx.run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
