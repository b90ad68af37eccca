"""Lattice sharding arithmetic (the halo and boundary geometry) and the
training loop's fault-tolerance pieces."""
