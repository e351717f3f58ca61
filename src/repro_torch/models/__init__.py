"""models of the repro_torch port."""
