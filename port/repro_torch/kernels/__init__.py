"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``range_probe``: query-box vs tiled-layout probe, routed and dense,
  the serving hot spot (``repro_torch.serve``).
"""
