"""core of the repro_torch port."""
