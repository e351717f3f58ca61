"""kernels/octent of the repro_torch port."""
