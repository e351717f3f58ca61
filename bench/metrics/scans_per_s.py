"""LiDAR sweeps whose result reached the host in the window, over the
window's seconds (a request of several sweeps counts each)."""
UNIT = "scans/s"
SOURCE = "host_clock"


def read(ctx):
    if ctx.run.window_s <= 0 or not ctx.scans:
        return None
    return ctx.scans / ctx.run.window_s
