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


def universe(mbrs: torch.Tensor) -> torch.Tensor:
    """Tight bounding box of the whole dataset -> (4,)."""
    return torch.cat([mbrs[:, :2].amin(dim=0), mbrs[:, 2:].amax(dim=0)])


def intersects(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise closed-box intersection: (..., 4) x (..., 4) -> (...,)."""
    return ((a[..., XMIN] <= b[..., XMAX]) & (b[..., XMIN] <= a[..., XMAX])
            & (a[..., YMIN] <= b[..., YMAX]) & (b[..., YMIN] <= a[..., YMAX]))


def intersect_matrix(r: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) -> (N, M) bool intersect table."""
    return intersects(r[:, None, :], s[None, :, :])
