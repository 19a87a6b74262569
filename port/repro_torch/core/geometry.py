"""MBR (minimum bounding rectangle) geometry primitives.

An MBR is a float32 vector ``[xmin, ymin, xmax, ymax]``; a dataset is
an ``(N, 4)`` tensor.  Predicates use *closed* boxes (touching
boundaries intersect), as ``repro.core.geometry`` does.
"""
from __future__ import annotations

import torch

XMIN, YMIN, XMAX, YMAX = 0, 1, 2, 3

# inverted box (xmin > xmax): intersects nothing under the closed-box
# predicates below.  9e9 is not exact in float32; building the tensor
# from these Python floats rounds it exactly as the reference does.
SENTINEL_BOX = (9e9, 9e9, -9e9, -9e9)


def sentinel(device: torch.device | str | None = None) -> torch.Tensor:
    """The (4,) float32 sentinel box."""
    return torch.tensor(SENTINEL_BOX, dtype=torch.float32, device=device)


def centroids(mbrs: torch.Tensor) -> torch.Tensor:
    """(N, 4) -> (N, 2) box centres."""
    return (mbrs[..., :2] + mbrs[..., 2:]) * 0.5


def areas(mbrs: torch.Tensor) -> torch.Tensor:
    """(N, 4) -> (N,) box areas (degenerate and inverted boxes: 0)."""
    w = torch.clamp_min(mbrs[..., XMAX] - mbrs[..., XMIN], 0.0)
    h = torch.clamp_min(mbrs[..., YMAX] - mbrs[..., YMIN], 0.0)
    return w * h


def universe(mbrs: torch.Tensor, valid: torch.Tensor | None = None
             ) -> torch.Tensor:
    """Tight bounding box of the whole dataset -> (4,); ``valid`` masks
    out padding rows."""
    lo, hi = mbrs[:, :2], mbrs[:, 2:]
    if valid is not None:
        lo = torch.where(valid[:, None], lo, torch.inf)
        hi = torch.where(valid[:, None], hi, -torch.inf)
    return torch.cat([lo.amin(dim=0), hi.amax(dim=0)])


def intersects(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise closed-box intersection: (..., 4) x (..., 4) -> (...,)."""
    return ((a[..., XMIN] <= b[..., XMAX]) & (b[..., XMIN] <= a[..., XMAX])
            & (a[..., YMIN] <= b[..., YMAX]) & (b[..., YMIN] <= a[..., YMAX]))


def intersect_matrix(r: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M) bool intersect table."""
    return intersects(r[:, None, :], s[None, :, :])


def contains_point(boxes: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(K, 4) boxes x (N, 2) points -> (N, K) closed containment."""
    x, y = pts[:, None, 0], pts[:, None, 1]
    return ((boxes[None, :, XMIN] <= x) & (x <= boxes[None, :, XMAX])
            & (boxes[None, :, YMIN] <= y) & (y <= boxes[None, :, YMAX]))


def box_union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.minimum(a[..., :2], b[..., :2]),
                      torch.maximum(a[..., 2:], b[..., 2:])], dim=-1)


def clip_box(inner: torch.Tensor, outer: torch.Tensor) -> torch.Tensor:
    """``inner`` clamped into ``outer`` corner by corner (the
    reference's ``jnp.clip``: the lower bound first, then the upper)."""
    lo, hi = outer[..., :2], outer[..., 2:]
    return torch.cat([torch.minimum(torch.maximum(inner[..., :2], lo), hi),
                      torch.minimum(torch.maximum(inner[..., 2:], lo), hi)],
                     dim=-1)
