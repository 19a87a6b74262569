"""Distributed training helpers (twin of ``repro.dist``): gradient
compression over a process mesh.  The parameter sharding rules
(``repro.dist.sharding``) wait for ROADMAP Queue 1 item 10's model
side."""
from . import compress  # noqa: F401
