"""repro_torch.serve — request serving over the port's plans."""
