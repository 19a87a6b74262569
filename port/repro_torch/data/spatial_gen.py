"""Synthetic spatial dataset generators (torch twins of
``repro.data.spatial_gen``).

They draw from a ``torch.Generator`` on the target device and follow
the reference's distributions, not its bits (``jax.random`` cannot be
reproduced):

- ``osm_like``: 64 Gaussian hotspots with Pareto(1.2)+1 weights and
  log-uniform spreads in [1e-3, 10^-1.3], a 5% uniform background,
  centres clipped to the unit square, log-uniform half-extents in
  [1e-5, 10^-2.5].
- ``pi_like``: near-uniform cell-scale objects with a gentle density
  ripple, log-uniform half-extents in [10^-4.2, 10^-3.2].
"""
from __future__ import annotations

import torch

from ..device import resolve


def _uniform(g, shape, lo, hi, device):
    return torch.rand(shape, generator=g, device=device) * (hi - lo) + lo


def _boxes(pts, sz):
    return torch.cat([pts - sz, pts + sz], dim=-1).to(torch.float32)


def osm_points(n: int, g: torch.Generator, n_clusters: int = 64
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Object centres of ``osm_like`` and which of them are background:
    -> ``(pts[n, 2], background[n] bool)``."""
    dev = g.device
    # Pareto(b) = exp(Exp(1) / b): heavy-tailed cluster weights -> skew
    e = -torch.log1p(-torch.rand(n_clusters, generator=g, device=dev))
    w = torch.exp(e / 1.2) + 1.0
    cid = torch.multinomial(w / w.sum(), n, replacement=True, generator=g)
    centers = torch.rand(n_clusters, 2, generator=g, device=dev)
    spread = 10.0 ** _uniform(g, (n_clusters, 1), -3.0, -1.3, dev)
    noise = torch.randn(n, 2, generator=g, device=dev)
    pts = centers[cid] + spread[cid] * noise
    # 5% uniform background (rural roads / sparse features)
    bg = torch.rand(n, 3, generator=g, device=dev)
    background = bg[:, 0] < 0.05
    pts = torch.where(background[:, None], bg[:, 1:3], pts)
    return pts.clamp(0.0, 1.0), background


def osm_like(n: int, seed: int = 0, device=None, n_clusters: int = 64
             ) -> torch.Tensor:
    """(n, 4) float32 hotspot-clustered, heavy-tailed MBRs."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    pts, _ = osm_points(n, g, n_clusters)
    sz = 10.0 ** _uniform(g, (n, 2), -5.0, -2.5, dev)
    return _boxes(pts, sz)


def pi_like(n: int, seed: int = 0, device=None) -> torch.Tensor:
    """(n, 4) float32 dense, near-uniform small MBRs."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    pts = torch.rand(n, 2, generator=g, device=dev)
    ripple = (0.15 * torch.sin(6.28 * 3 * pts[:, :1])
              * torch.sin(6.28 * 2 * pts[:, 1:]))
    noise = torch.randn(n, 2, generator=g, device=dev)
    pts = (pts + ripple * noise * 0.02).clamp(0.0, 1.0)
    sz = 10.0 ** _uniform(g, (n, 2), -4.2, -3.2, dev)
    return _boxes(pts, sz)


def dataset(name: str, n: int, seed: int = 0, device=None) -> torch.Tensor:
    if name == "osm":
        return osm_like(n, seed, device)
    if name == "pi":
        return pi_like(n, seed, device)
    raise KeyError(name)
