"""PyTorch/CUDA port of ``repro``: partition, join, stage and serve
range and kNN queries, and run Mamba2 inference, on an NVIDIA H100.

The module tree mirrors ``repro`` so each module's counterpart is easy
to find.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU every kernel runs its plain PyTorch
version (``kernels/*/ref.py``), on the card the hand-written CUDA
kernel (``kernels/*/csrc``).  Ported so far: the six Table-1
partitioners with the paper's metrics, cost model and sampling; the
spatial join on one device (``query.engine``); the replicated,
single-device server (range counts, range ids and kNN, pruned and
dense) with the ``"x"`` and ``"hilbert"`` local indexes; the LM
substrate's Mamba2 inference (``models``, ``configs``: prefill through
the chunked SSD, greedy decode through the state recurrence,
``launch.serve``); and all twelve kernels (``range_probe``,
``hilbert``, ``mbr_join``, ``ssd``).  Features of
``repro`` not ported yet raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
