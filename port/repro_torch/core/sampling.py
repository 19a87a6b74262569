"""Sampling-based partitioning (section 5.2), torch twin of
``repro.core.sampling``.

Partition a gamma-sample with a proportionally scaled payload
(gamma * b), then map the layout back onto the full dataset.  For
universe-covering methods (FG/BSP/SLC/BOS) the layout transfers once
its rim is stretched to the full universe; for tight-MBR methods
(HC/STR) the sampled layout may leave gaps, which ``evaluate_on_full``
shows as objects with no copy.  The sample is drawn with
``torch.randperm`` from an explicit ``torch.Generator``: its bits are
not ``jax.random``'s, so tests hand both packages the same sample.
"""
from __future__ import annotations

import dataclasses

import torch

from . import geometry
from .partition import api
from .partition.assign import partition_counts


@dataclasses.dataclass(frozen=True)
class SampledResult:
    parts: api.Partitioning
    sample_size: int
    sample_payload: int


def sampled_partition(method: str, mbrs: torch.Tensor, payload: int,
                      gamma: float, generator: torch.Generator
                      ) -> SampledResult:
    n = mbrs.shape[0]
    s = max(2, int(round(gamma * n)))
    payload_s = max(1, int(round(gamma * payload)))
    perm = torch.randperm(n, generator=generator,
                          device=generator.device)[:s].to(mbrs.device)
    return partition_sample(method, mbrs, mbrs[perm], payload_s)


def partition_sample(method: str, mbrs: torch.Tensor, sample: torch.Tensor,
                     payload_s: int) -> SampledResult:
    """Partition ``sample`` at ``payload_s`` and fit the layout to
    ``mbrs`` (the step after the draw)."""
    parts = api.partition(method, sample, payload_s)
    if api.info(method).covers_universe:
        # the sampled layout covers the SAMPLE's universe; snap its rim
        # outward to the full-data universe so the transfer stays gap-free
        parts = _extend_rim(parts, geometry.universe(sample),
                            geometry.universe(mbrs))
    return SampledResult(parts=parts, sample_size=sample.shape[0],
                         sample_payload=payload_s)


def _extend_rim(parts: api.Partitioning, uni_s: torch.Tensor,
                uni_f: torch.Tensor) -> api.Partitioning:
    """Stretch boxes touching the sample-universe rim to the full one."""
    eps = 1e-6 * torch.clamp_min(uni_s[2:] - uni_s[:2], 1e-9)
    b = parts.boxes
    lo = torch.where(b[:, :2] <= uni_s[:2] + eps,
                     torch.minimum(b[:, :2], uni_f[:2]), b[:, :2])
    hi = torch.where(b[:, 2:] >= uni_s[2:] - eps,
                     torch.maximum(b[:, 2:], uni_f[2:]), b[:, 2:])
    boxes = torch.where(parts.valid[:, None], torch.cat([lo, hi], dim=-1), b)
    return api.Partitioning(boxes=boxes.to(torch.float32), valid=parts.valid)


def evaluate_on_full(res: SampledResult, mbrs: torch.Tensor):
    """Map a sampled layout back to the full dataset -> ``(counts,
    copies)``; ``copies == 0`` rows are the HC/STR gap objects."""
    return partition_counts(mbrs, res.parts)


def nearest_box_fallback(mbrs: torch.Tensor, parts: api.Partitioning
                         ) -> torch.Tensor:
    """For gap objects: index of the valid partition whose box centre is
    nearest to the object centroid -> (N,) int32."""
    c = geometry.centroids(mbrs)
    bc = (parts.boxes[:, :2] + parts.boxes[:, 2:]) * 0.5
    d2 = ((c[:, None, :] - bc[None, :, :]) ** 2).sum(-1)
    d2 = torch.where(parts.valid[None, :], d2, torch.inf)
    return d2.argmin(dim=1).to(torch.int32)
