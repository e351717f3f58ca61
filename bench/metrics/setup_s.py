"""Set-up: from process start to the window's start (weights, the
program's build or load of its kernels, the traffic's bases, warm-up)."""
UNIT = "s"
SOURCE = "host_clock"


def read(ctx):
    return ctx.run.setup_s
