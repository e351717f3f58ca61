"""kernels of the repro_torch port."""
