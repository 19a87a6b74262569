"""ssd: the Mamba2 SSD (state-space duality) block, the LM substrate's
prefill hot spot (``repro_torch.models.ssm``).

``ops`` is the public surface (CPU -> ``ref``, CUDA -> ``kernel``),
``ref`` the plain PyTorch versions, ``kernel`` the build, binding and
launch wrapper of the hand-written Hopper kernel in ``csrc/``.
"""
from . import kernel, ops, ref  # noqa: F401
