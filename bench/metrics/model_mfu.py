"""The model's operations over the window (every sparse layer's 2 x
kernel-map pairs x Cin x Cout and the head's, counted from the
reference's kernel maps whatever runs them, ``bench/workcount.py``), over
the window's seconds, as a share of the 3xTF32 rate of 495 / 3 TFLOP/s:
float32-accurate work on the tensor cores."""
from bench import peaks, workcount

UNIT = "%"
SOURCE = "host_clock"
LAYER = "model step (models/minkunet.py forward)"
MOVES = "scans_per_s"


def read(ctx):
    if ctx.run.window_s <= 0 or not ctx.completed:
        return None
    f = sum(workcount.flops(layers) for layers, _ in ctx.work())
    return 100.0 * f / ctx.run.window_s / peaks.F32_TC_FLOPS
