"""LM model stack (port of ``repro.models``): the transformer families
(``common``, ``ffn``, ``attention``, ``mla``, ``moe``, ``transformer``), the
zamba hybrid (``mamba2``, ``zamba``) and the family registry.  The reference's activation-sharding constraints
(``distributed/act_sharding.shard``) are not ported: on one card they are
no-ops."""
