"""Training: the step and the loop (port of ``repro.train``)."""
