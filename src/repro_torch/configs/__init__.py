"""SU3_Bench lattice configurations."""
