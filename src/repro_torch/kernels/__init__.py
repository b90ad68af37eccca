"""Hand-written CUDA kernels (the SU3 hot spot and prefill attention), their
plain PyTorch versions, and torch oracles (ref.py)."""
