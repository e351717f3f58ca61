"""runtime of the repro_torch port."""
