"""Kernel 1 (``csrc/octent_query.cu``) against its roofline: the least
time the bytes of the window's Subm3 map searches take at the HBM's
bandwidth (each query's key read once, the table's keys read once, the
27-tap kernel map written once; counted from the reference's coordinate
sets, ``bench/workcount.py``), over the device time of kernel 1's
launches in the trace. Nothing to read where no request searches."""
from bench import peaks, trace, workcount

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernel 1 (kernels/octent, csrc/octent_query.cu)"
MOVES = "scans_per_s"
KERNELS = ("octent_index_kernel", "octent_query_kernel")


def read(ctx):
    if ctx.run.trace is None:
        return None
    t = trace.seconds_matching(ctx.run.trace, KERNELS)
    if t <= 0:
        return None
    b = sum(workcount.search_bytes(s) for _, s in ctx.work())
    return 100.0 * b / peaks.HBM_BYTES_S / t
