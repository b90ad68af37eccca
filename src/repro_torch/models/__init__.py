"""LM model stack (port of ``repro.models``): the transformer families
(``common``, ``ffn``, ``attention``, ``mla``, ``moe``, ``transformer``), the
zamba hybrid (``mamba2``, ``zamba``) and the family registry.  The dense
family calls ``distributed/act_sharding.shard`` at the reference's sites:
on a mesh it pins a DTensor activation's placements, elsewhere it returns
its argument."""
