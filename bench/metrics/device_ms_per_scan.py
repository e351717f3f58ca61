"""The device's busy time over the traced window, a sweep."""
UNIT = "ms"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "scans_per_s"


def read(ctx):
    t = ctx.run.trace
    if t is None or not ctx.scans:
        return None
    return 1e3 * t.busy_s / ctx.scans
