"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``range_probe``: query-box vs tiled-layout probe, routed and dense,
  the serving hot spot (``repro_torch.serve``).
- ``hilbert``: the Hilbert-curve xy->d encode, the hc partitioner's and
  the ``"hilbert"`` local index's sort key.
- ``mbr_join``: blocked pairwise MBR intersection, the per-tile join
  filter (``repro_torch.query.join``).
- ``ssd``: the Mamba2 SSD intra-chunk block, the LM prefill's hot spot
  (``repro_torch.models.ssm``).

``cuda_build`` builds and binds every family's source.
"""
