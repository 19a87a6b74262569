"""PyTorch/CUDA port of ``repro``: partition, stage and serve routed
range queries on an NVIDIA H100.

The module tree mirrors ``repro`` so each module's counterpart is easy
to find.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel runs its plain PyTorch
version (``kernels/*/ref.py``), on the card the hand-written CUDA
kernel (``kernels/*/csrc``).  This slice ports the replicated,
single-device range-serving path: ``bsp`` partitioning, MASJ staging
with the ``"x"`` local index, candidate routing, and the four gathered
``range_probe`` kernels.  Features of ``repro`` not ported yet raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
