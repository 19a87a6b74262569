"""Distributed training helpers (twin of ``repro.dist``): gradient
compression over a process mesh (``compress``), the parameter
partitioning rules over a ``("data", "model")`` mesh (``sharding``) and
the tensor- and data-parallel pieces of the sharded train step
(``parallel``)."""
from . import compress  # noqa: F401
