"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``range_probe``: routed query-box vs tiled-layout probe, the serving
  hot spot (``repro_torch.serve``).
"""
