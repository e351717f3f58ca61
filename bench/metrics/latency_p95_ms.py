"""The 95th percentile of the window's request latencies: each from the
hand-over of its host arrays to its outputs back as host arrays."""
import numpy as np

UNIT = "ms"
SOURCE = "host_clock"


def read(ctx):
    lat = [r.latency_s for r in ctx.completed]
    return float(np.percentile(lat, 95) * 1e3) if lat else None
