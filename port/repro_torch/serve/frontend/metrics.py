"""Request-plane observability: counters, per-tenant accounting, and
latency histograms, surfaced as one plain dict (``snapshot()``) (twin
of ``repro.serve.frontend.metrics``).

The metrics answer the three questions an operator of the serving
front-end asks:

- **admission** — how much traffic is being turned away (``rejected``
  backpressure, ``timed_out`` SLO misses) and who it belongs to
  (per-tenant counters);
- **batching efficiency** — batch fill ratio (admitted requests per
  batch slot) and padded-slot waste, the cost of the fixed
  batch-shape ladder;
- **latency** — per-request queue / execute / total histograms with
  p50/p90/p99, the open-loop numbers of a run under offered load.

Everything is plain Python on the host — metrics never touch the
device.
"""
from __future__ import annotations

import dataclasses


class Histogram:
    """Latency histogram with exact percentiles.

    Raw samples are kept (seconds, float) up to ``cap`` and then
    reservoir-subsampled by simple decimation (every other sample is
    dropped and the stride doubles), so long benches stay O(cap) memory
    while percentiles remain representative; ``count``/``total`` are
    always exact.
    """

    def __init__(self, cap: int = 100_000):
        self._cap = cap
        self._stride = 1
        self._tick = 0
        self.samples: list[float] = []
        self.count = 0
        self.total = 0.0
        self.max = 0.0

    def record(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v > self.max:
            self.max = v
        self._tick += 1
        if self._tick >= self._stride:
            self._tick = 0
            self.samples.append(v)
            if len(self.samples) >= self._cap:
                self.samples = self.samples[::2]
                self._stride *= 2

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the kept samples (0 when
        empty)."""
        if not self.samples:
            return 0.0
        s = sorted(self.samples)
        idx = min(len(s) - 1, max(0, int(round(p / 100.0 * len(s))) - 1))
        return s[idx]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        return dict(count=self.count, mean=self.mean, max=self.max,
                    p50=self.percentile(50), p90=self.percentile(90),
                    p99=self.percentile(99))


@dataclasses.dataclass
class _TenantCounters:
    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    timed_out: int = 0
    completed: int = 0


class FrontendMetrics:
    """One mutable metrics sink per frontend (see module docstring)."""

    def __init__(self):
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0
        self.timed_out = 0
        self.completed = 0
        self.batches = 0
        self.batch_slots = 0        # sum of padded batch widths
        self.batch_fill = 0         # sum of real requests per batch
        self.queue_depth = 0        # live gauge, mirrors the plane
        self.queue_depth_max = 0
        self.tenants: dict[str, _TenantCounters] = {}

        self.queue_s = Histogram()      # arrival -> batch formed
        self.execute_s = Histogram()    # batch formed -> results ready
        self.total_s = Histogram()      # arrival -> response

    def _tenant(self, tenant: str) -> _TenantCounters:
        tc = self.tenants.get(tenant)
        if tc is None:
            tc = self.tenants[tenant] = _TenantCounters()
        return tc

    # -- admission --------------------------------------------------------

    def on_submit(self, tenant: str, admitted: bool, depth: int) -> None:
        self.submitted += 1
        tc = self._tenant(tenant)
        tc.submitted += 1
        if admitted:
            self.admitted += 1
            tc.admitted += 1
            self.queue_depth = depth
            if depth > self.queue_depth_max:
                self.queue_depth_max = depth
        else:
            self.rejected += 1
            tc.rejected += 1

    def on_timeout(self, tenant: str) -> None:
        self.timed_out += 1
        self._tenant(tenant).timed_out += 1

    # -- batching ---------------------------------------------------------

    def on_batch(self, width: int, fill: int, depth: int) -> None:
        self.batches += 1
        self.batch_slots += width
        self.batch_fill += fill
        self.queue_depth = depth

    def on_complete(self, tenant: str, queue_s: float, execute_s: float,
                    total_s: float) -> None:
        self.completed += 1
        self._tenant(tenant).completed += 1
        self.queue_s.record(queue_s)
        self.execute_s.record(execute_s)
        self.total_s.record(total_s)

    # -- reporting --------------------------------------------------------

    @property
    def batch_fill_ratio(self) -> float:
        return self.batch_fill / self.batch_slots if self.batch_slots else 0.0

    @property
    def padded_slots(self) -> int:
        return self.batch_slots - self.batch_fill

    def snapshot(self) -> dict:
        """Everything as one plain dict (JSON-ready)."""
        return dict(
            submitted=self.submitted, admitted=self.admitted,
            rejected=self.rejected, timed_out=self.timed_out,
            completed=self.completed, batches=self.batches,
            batch_slots=self.batch_slots, batch_fill=self.batch_fill,
            batch_fill_ratio=round(self.batch_fill_ratio, 4),
            padded_slots=self.padded_slots,
            queue_depth_max=self.queue_depth_max,
            queue_s=self.queue_s.snapshot(),
            execute_s=self.execute_s.snapshot(),
            total_s=self.total_s.snapshot(),
            tenants={t: dataclasses.asdict(c)
                     for t, c in sorted(self.tenants.items())},
        )
