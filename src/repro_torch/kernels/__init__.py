"""Hand-written CUDA kernels for the SU3 hot spot, their plain PyTorch
versions, and torch oracles (ref.py)."""
