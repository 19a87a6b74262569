"""Tile -> device packing for the join engine (the reference's import
path; the packers live in ``core.placement``)."""
from __future__ import annotations

from ..core.placement import (  # noqa: F401
    lpt_pack,
    round_robin_pack,
    tile_costs,
)
