"""LM model stack (port of ``repro.models``): the dense transformer family
(``common``, ``ffn``, ``attention``, ``transformer``) and the family
registry.  The reference's activation-sharding constraints
(``distributed/act_sharding.shard``) are not ported: on one card they are
no-ops."""
