"""`ServeConfig`: the one frozen description of how a server serves
(twin of ``repro.serve.config``: same fields, same validation).

Axes: ``placement`` (``"replicated"`` | ``"sharded"`` | ``"heat"``),
``probe`` (``"pruned"`` | ``"dense"``), ``local_index`` (``"off"`` |
``"x"`` | ``"hilbert"``), ``chunk`` (chunk-box granularity, a multiple
of 128), ``capacity``/``slack`` (per-tile member slots), ``shards``,
``axis``, the compaction thresholds, and the heat ``policy``.  The
port serves every placement (the ``shards`` owners of ``"sharded"``
and ``"heat"`` simulated on one device, or one a rank of a process
mesh) with every ``probe`` and ``local_index``.
"""
from __future__ import annotations

import dataclasses

from ..kernels.range_probe.kernel import CHUNK

PLACEMENTS = ("replicated", "sharded", "heat")
PROBES = ("pruned", "dense")
LOCAL_INDEXES = ("off", "x", "hilbert")


@dataclasses.dataclass(frozen=True)
class PlacementPolicy:
    """How owner-routed placements track query heat: EWMA
    ``heat_decay``, ``replicate_top`` hot tiles kept on a second owner,
    and an optional automatic ``rebalance_every`` N batches."""

    heat_decay: float = 0.85
    replicate_top: int = 0
    rebalance_every: int | None = None

    def __post_init__(self):
        if not 0.0 < self.heat_decay <= 1.0:
            raise ValueError(f"heat_decay must be in (0, 1], "
                             f"got {self.heat_decay}")
        if self.replicate_top < 0:
            raise ValueError(f"replicate_top must be >= 0, "
                             f"got {self.replicate_top}")
        if self.rebalance_every is not None and self.rebalance_every < 1:
            raise ValueError(f"rebalance_every must be >= 1 or None, "
                             f"got {self.rebalance_every}")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Frozen serving configuration (see module docstring for axes)."""

    placement: str = "replicated"
    probe: str = "pruned"
    local_index: str = "x"
    chunk: int = CHUNK
    capacity: int | None = None
    slack: int = 0
    shards: int | None = None
    axis: str = "d"
    compact_dead_frac: float | None = 0.5
    restage_dead_frac: float | None = None
    policy: PlacementPolicy = PlacementPolicy()

    def __post_init__(self):
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, "
                             f"got {self.placement!r}")
        if self.probe not in PROBES:
            raise ValueError(f"probe must be one of {PROBES}, "
                             f"got {self.probe!r}")
        if self.local_index not in LOCAL_INDEXES:
            raise ValueError(f"local_index must be one of {LOCAL_INDEXES}, "
                             f"got {self.local_index!r}")
        if self.chunk <= 0 or self.chunk % CHUNK:
            raise ValueError(f"chunk must be a positive multiple of the "
                             f"kernel chunk {CHUNK}, got {self.chunk}")
        if self.capacity is not None and self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.slack < 0:
            raise ValueError(f"slack must be >= 0, got {self.slack}")
        if self.shards is not None and self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.shards is not None and self.placement == "replicated":
            raise ValueError("shards is only meaningful with "
                             "placement='sharded' or 'heat'")
        if not isinstance(self.policy, PlacementPolicy):
            raise ValueError(f"policy must be a PlacementPolicy, "
                             f"got {type(self.policy).__name__}")
        for name in ("compact_dead_frac", "restage_dead_frac"):
            frac = getattr(self, name)
            if frac is not None and not 0.0 < frac <= 1.0:
                raise ValueError(f"{name} must be in (0, 1] or None, "
                                 f"got {frac}")

    @property
    def indexed(self) -> bool:
        """Whether staging builds the intra-tile local index."""
        return self.local_index != "off"

    def replace(self, **changes) -> "ServeConfig":
        """A copy with ``changes`` applied (``dataclasses.replace``)."""
        return dataclasses.replace(self, **changes)
