"""The distributed layer (port of ``repro.dist``) over ``torch.distributed``:
counted collectives and the hierarchical reduction (``collectives``),
sequence-parallel decode attention (``attention``), GPipe (``pipeline``)
and logical sharding rules (``sharding``).  Ranks join through
``repro_torch.launch.mesh.init_distributed``."""
