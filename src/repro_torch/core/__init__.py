"""Core: the SU3 lattice engine and the Hopper roofline."""
