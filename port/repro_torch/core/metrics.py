"""Partition-quality metrics from the paper (section 6.3-6.4), torch
twins of ``repro.core.metrics``.

- ``balance_stddev``  -- Fig 3's skewness measure,
- ``boundary_ratio``  -- lambda (eq. 2),
- ``skew_ratio``      -- max/mean payload (the straggler factor),
- ``coverage``        -- fraction of objects assigned to >= 1 partition,
- ``padding_waste``   -- fraction of padded-tile slots that are padding.

Each returns a 0-d float32 tensor.  The sums run in float32 in torch's
order, not XLA's, so they agree with the reference to a relative
1e-6 over a few thousand tiles, not bit for bit.
"""
from __future__ import annotations

import torch


def _k(valid: torch.Tensor) -> torch.Tensor:
    return valid.sum().clamp_min(1)


def _mean(c: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, c, 0.0).sum() / _k(valid)


def balance_stddev(counts: torch.Tensor, valid: torch.Tensor
                   ) -> torch.Tensor:
    c = counts.float()
    mean = _mean(c, valid)
    var = torch.where(valid, (c - mean) ** 2, 0.0).sum() / _k(valid)
    return torch.sqrt(var)


def boundary_ratio(counts: torch.Tensor, valid: torch.Tensor,
                   n_objects: int) -> torch.Tensor:
    """lambda = sum |p_i| / |R| - 1 (0 when no boundary objects)."""
    total = torch.where(valid, counts, 0).sum()
    return total.float() / torch.tensor(float(n_objects), dtype=torch.float32,
                                        device=counts.device) - 1.0


def skew_ratio(counts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    c = counts.float()
    mx = torch.where(valid, c, 0.0).max()
    return mx / _mean(c, valid).clamp_min(1e-9)


def coverage(copies: torch.Tensor) -> torch.Tensor:
    covered = (copies > 0).sum()
    return covered.float() / torch.tensor(float(copies.shape[0]),
                                          dtype=torch.float32,
                                          device=copies.device)


def padding_waste(counts: torch.Tensor, valid: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    used = torch.where(valid, counts, 0).clamp_max(capacity).sum()
    slots = (valid.sum() * capacity).clamp_min(1)
    return 1.0 - used.float() / slots.float()
