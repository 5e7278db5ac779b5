"""The port's distribution layer (``repro.dist``): the sharding policy
table (:mod:`.rules`), the spec derivation bound to a mesh
(:mod:`.sharding`), and the collectives that the paper's explicit
techniques call on a ``torch.distributed`` mesh (:mod:`.compat`)."""
