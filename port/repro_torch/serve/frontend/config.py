"""`FrontendConfig`: the one frozen description of how the request
plane admits, batches, and schedules single-query traffic (twin of
``repro.serve.frontend.config``: same fields, same validation).

The batched ``SpatialServer`` serves whole query batches; production
traffic arrives one query at a time.  The config names the knobs that
bridge the two:

- ``ladder`` — the batch-shape ladder, ascending (default
  64/128/256/512).  A closing batch pads up to the smallest rung that
  holds its requests, so a steady stream touches at most
  ``len(ladder)`` batch widths per query kind (the reference's
  recompile guard; on the card it bounds the shapes the kernels and
  the caching allocator see).
- ``max_delay`` — the batch-forming window in seconds: a batch closes
  when it reaches the top rung ("full") or when its oldest request has
  waited ``max_delay`` ("deadline"), whichever is first.  Small values
  trade fill ratio for latency.
- ``queue_limit`` — admission control: the total number of requests
  the plane will hold across all tenants and query kinds.  A submit
  past the limit is **rejected** immediately (explicit backpressure,
  never unbounded buffering).
- ``quantum`` — deficit-round-robin fairness: each tenant may place at
  most ``quantum`` requests into a forming batch per rotation turn, so
  one hot tenant cannot starve the rest — cold tenants keep landing in
  every batch.
- ``default_deadline`` — per-request latency budget in seconds
  (``None`` = no budget).  A request still queued past its deadline is
  **timed out** (never executed) with an explicit outcome; per-request
  ``deadline=`` overrides.

Frozen and hashable, like ``ServeConfig``: a frontend's behaviour is
one immutable, loggable value.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Frozen request-plane configuration (see module docstring)."""

    ladder: tuple = (64, 128, 256, 512)
    max_delay: float = 0.002
    queue_limit: int = 4096
    quantum: int = 16
    default_deadline: float | None = None

    def __post_init__(self):
        ladder = tuple(int(w) for w in self.ladder)
        object.__setattr__(self, "ladder", ladder)
        if not ladder or any(w < 1 for w in ladder):
            raise ValueError(f"ladder must be non-empty positive widths, "
                             f"got {ladder}")
        if list(ladder) != sorted(set(ladder)):
            raise ValueError(f"ladder must be strictly ascending, "
                             f"got {ladder}")
        if self.max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {self.max_delay}")
        if self.queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, "
                             f"got {self.queue_limit}")
        if self.quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {self.quantum}")
        if self.default_deadline is not None and self.default_deadline <= 0:
            raise ValueError(f"default_deadline must be positive, "
                             f"got {self.default_deadline}")

    @property
    def max_batch(self) -> int:
        return self.ladder[-1]

    def width_for(self, n: int) -> int:
        """Smallest ladder rung holding ``n`` requests (n <= top rung;
        the plane never forms a batch past ``max_batch``)."""
        for w in self.ladder:
            if n <= w:
                return w
        raise ValueError(f"batch of {n} exceeds the ladder top rung "
                         f"{self.ladder[-1]}")

    def replace(self, **changes) -> "FrontendConfig":
        return dataclasses.replace(self, **changes)
