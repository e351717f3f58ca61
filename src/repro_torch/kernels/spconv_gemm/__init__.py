"""kernels/spconv_gemm of the repro_torch port."""
