"""range_probe: query-box vs tiled-layout probe, routed (``gathered_*``)
and dense (``probe_*``).

``ops`` is the public surface (CPU -> ``ref``, CUDA -> ``kernel``),
``ref`` the plain PyTorch oracles, ``kernel`` the build, binding and
launch wrappers of the hand-written Hopper kernels in ``csrc/``.
"""
from . import kernel, ops, ref  # noqa: F401
