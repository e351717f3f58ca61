"""Block-masked dense matmul: SPAC tile skipping on one GEMM (§V-B)."""
