"""launch of the repro_torch port."""
