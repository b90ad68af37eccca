"""Lattice sharding arithmetic (the halo and boundary geometry)."""
