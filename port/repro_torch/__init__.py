"""PyTorch/CUDA port of ``repro``: partition, stage and serve range and
kNN queries on an NVIDIA H100.

The module tree mirrors ``repro`` so each module's counterpart is easy
to find.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel runs its plain PyTorch
version (``kernels/*/ref.py``), on the card the hand-written CUDA
kernel (``kernels/*/csrc``).  Ported so far: the replicated,
single-device server (range counts, range ids and kNN, pruned and
dense), ``bsp`` partitioning, MASJ staging with the ``"x"`` local
index, probe-box and MINDIST routing, and the eight ``range_probe``
kernels.  Features of ``repro`` not ported yet raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
