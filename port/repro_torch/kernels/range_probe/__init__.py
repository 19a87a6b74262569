"""range_probe: routed query-box vs tiled-layout probe.

``ops`` is the public surface (CPU -> ``ref``, CUDA -> ``kernel``),
``ref`` the plain PyTorch oracles, ``kernel`` the build, binding and
launch wrappers of the hand-written Hopper kernel in ``csrc/``.
"""
from . import kernel, ops, ref  # noqa: F401
