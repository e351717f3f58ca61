"""data of the repro_torch port."""
