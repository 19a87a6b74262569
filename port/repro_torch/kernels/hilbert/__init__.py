"""hilbert: the Hilbert-curve xy->d encode, the hc partitioner's and
the ``"hilbert"`` local index's sort key.

``ops`` is the public surface (CPU -> ``ref``, CUDA -> ``kernel``),
``ref`` the plain PyTorch version, ``kernel`` the build, binding and
launch wrapper of the hand-written Hopper kernel in ``csrc/``.
"""
from . import kernel, ops, ref  # noqa: F401
