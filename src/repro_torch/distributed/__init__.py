"""Lattice sharding arithmetic (the halo and boundary geometry), the LM
sharding rules and their DTensor placements, activation placements
(``act_sharding``), GPipe over logical stages and the training loop's
fault-tolerance pieces."""
