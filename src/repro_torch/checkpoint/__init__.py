"""Checkpoints of training state (port of ``repro.checkpoint``)."""
