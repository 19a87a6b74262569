"""Clocks for the request plane (twin of ``repro.serve.frontend.clock``).

Every time the plane reads comes through one of these, so the whole
request lifecycle — arrival, batch-forming deadlines, SLO budgets,
latency accounting — runs identically against wall time
(``MonotonicClock``, production/asyncio) or a manually-advanced
``VirtualClock`` (deterministic tests and the open-loop simulator,
where queueing math is exact and repeatable).
"""
from __future__ import annotations

import time


class MonotonicClock:
    """Wall time via ``time.monotonic`` (seconds, arbitrary epoch)."""

    def now(self) -> float:
        return time.monotonic()


class VirtualClock:
    """Deterministic manually-advanced clock.  Never moves on its own;
    ``advance`` / ``advance_to`` are the only mutators and time never
    goes backwards."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance by {dt} (time is monotonic)")
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        if t < self._now:
            raise ValueError(f"cannot rewind {self._now} -> {t}")
        self._now = float(t)
        return self._now
