"""Tile -> device packing (the reference's import path; the packers
live in ``core.placement``)."""
from __future__ import annotations

from ..core.placement import (  # noqa: F401
    lpt_pack,
    lpt_pack_capped,
    round_robin_pack,
    shard_tiles,
    tile_costs,
)
