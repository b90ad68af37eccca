"""Optimizer and gradient compression (port of ``repro.optim``)."""
