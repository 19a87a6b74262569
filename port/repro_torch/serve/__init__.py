"""Batched spatial query serving: range and kNN, pruned and dense.

- ``config``: ``ServeConfig`` / ``PlacementPolicy``.
- ``router``: probe-box and MINDIST routing, fixed-width ``(Q, F)``
  candidate lists, the region fan-out metric and ``HeatTracker``.
- ``layout``: ``stage_tiles`` (MASJ tiles, canonical marks, probe
  boxes, the ``"x"`` and ``"hilbert"`` local indexes, the alive mask),
  ``StagedLayout``, the ``TileLayout`` protocol and its placements
  (``ReplicatedTiles``; ``ShardedTiles`` over ``shard_staged``'s
  ``ShardedLayout``, ``pack_queries``; ``HeatSharded``, its heat-aware
  re-plan and hot-tile replicas), and the ingest lifecycle
  (``append``, ``delete``, ``update``, ``compact``).
- ``exchange``: the sharded placement's owner-routed scatter, probe
  and merge, the owners simulated on one device or one a rank of a
  process mesh (``launch.mesh``).
- ``engine``: ``SpatialServer`` and ``WidthPolicy``.
- ``frontend``: the request plane in front of the server (admission,
  per-tenant fairness, deadline-or-full padded batches), its asyncio
  wrapper and the open-loop simulator.
"""
from . import config, engine, exchange, frontend, layout, router  # noqa: F401
from .config import PlacementPolicy, ServeConfig  # noqa: F401
from .engine import SpatialServer, WidthPolicy  # noqa: F401
from .frontend import (  # noqa: F401
    FrontendConfig,
    ServeFrontend,
)
from .layout import (  # noqa: F401
    HeatSharded,
    ReplicatedTiles,
    ShardedLayout,
    ShardedTiles,
    StagedLayout,
    TileLayout,
    build_tiles,
    pack_queries,
    shard_staged,
    stage_tiles,
    staged_from_numpy,
)
from .router import HeatTracker  # noqa: F401
