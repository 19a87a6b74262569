"""mbr_join: blocked pairwise MBR intersection, the per-tile spatial
join filter (the paper's query phase D).

``ops`` is the public surface (CPU -> ``ref``, CUDA -> ``kernel``),
``ref`` the plain PyTorch versions, ``kernel`` the build, binding and
launch wrappers of the hand-written Hopper kernels in ``csrc/``.
"""
from . import kernel, ops, ref  # noqa: F401
