"""Kernel 2 (``csrc/spconv_gemm_fused.cu``: its planning, fused and
split-sum kernels) against its roofline: for each layer it runs, the
larger of its operations (2 x kernel-map pairs x Cin x Cout) at the
3xTF32 rate and its bytes (valid input rows read once, weights, valid
output rows written once) at the HBM's bandwidth, counted from the
reference's kernel maps (``bench/workcount.py``), summed over the
window's requests, over the device time of kernel 2's launches in the
trace. Kernel 2 runs every sparse layer of MinkUNet; the linear head is
a plain matrix product and is not counted."""
from bench import peaks, trace, workcount

UNIT = "%"
SOURCE = "device_trace"
LAYER = "kernel 2 (kernels/spconv_gemm, csrc/spconv_gemm_fused.cu)"
MOVES = "scans_per_s"
KERNELS = ("spconv_gemm_fused_kernel", "spconv_split_plan_kernel",
           "spconv_split_reduce_kernel")


def bound_s(layers) -> float:
    return sum(max(workcount.flops([ly]) / peaks.F32_TC_FLOPS,
                   workcount.gemm_bytes([ly]) / peaks.HBM_BYTES_S)
               for ly in layers if ly.kind in workcount.SPARSE)


def read(ctx):
    if ctx.run.trace is None:
        return None
    t = trace.seconds_matching(ctx.run.trace, KERNELS)
    if t <= 0:
        return None
    return 100.0 * sum(bound_s(layers) for layers, _ in ctx.work()) / t
