"""The port's static hazard checker (twin of ``repro.analysis``),
run over ``repro_torch`` itself.

Five package-specific rules, each the reference's bug class read in
torch's terms:

  jit-closure-capture   R1  staged tensors captured by callables that
                            outlive the call (stale after a re-stage)
  recompile-hazard      R2  unbucketed ints into the bucketed width
                            parameters
  host-sync             R3  device->host reads on hot paths
  kernel-twin-parity    R4  *_skip twins + alive / extent threading
  layout-conformance    R5  TileLayout contract + replica fan-out

Entry point: ``repro_torch.analysis.api.run``; from ``port/``:
``python -m repro_torch.analysis repro_torch``.  The analyzer is AST
plus CPU calls of the plain twins only — it never builds or launches a
kernel.
"""

from .core import Finding  # noqa: F401
from .api import RULE_IDS, run  # noqa: F401
