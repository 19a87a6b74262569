"""The sans-IO request plane: admission control, per-tenant deficit
round robin, and deadline-or-full batch forming (twin of
``repro.serve.frontend.plane``, the same decisions).

This is the deterministic core of the async front-end.  It owns no
clock, no event loop, and no executor — every method takes ``now``
explicitly, so the same state machine runs under asyncio against wall
time (``frontend.ServeFrontend``), under the open-loop simulator
(``frontend.sim``), and under the virtual-clock unit tests,
with identical behaviour.

Lifecycle of a request:

1. ``submit(req, now)`` — admission control.  The plane holds at most
   ``config.queue_limit`` requests across all tenants and query
   classes; past that a submit is **rejected** immediately (explicit
   backpressure — the caller sees the overload instead of an unbounded
   queue hiding it).  Admitted requests join their (kind, params)
   class queue under their tenant.
2. batch forming — a class closes a batch when it holds a full top
   rung of requests, or when its oldest request has waited
   ``config.max_delay``; ``next_due(now)`` tells the caller's loop
   when to wake.  ``form_batch(now)`` pops requests by **deficit round robin**
   over tenants (at most ``config.quantum`` per tenant per rotation
   turn, rotation persists across batches), so one hot tenant cannot
   starve the rest.  Requests whose deadline already passed are
   **timed out** at pop time — returned separately, never executed.
   The batch is padded up to the smallest ladder rung that holds it
   (``config.ladder``), so executors see a few fixed batch shapes.
3. execution and response delivery belong to the caller's loop
   (``executor.execute_batch`` + the asyncio wrapper or simulator).

Query classes: requests only batch with requests of the same kind
*and* static params (``max_hits`` / ``(k, max_cand)``), because those
are arguments of the batched server call shared by the whole batch.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from collections import deque
from typing import Any

from .config import FrontendConfig
from .metrics import FrontendMetrics

KINDS = ("range_counts", "range_ids", "knn")


class Outcome(enum.Enum):
    """Terminal state of one request."""
    OK = "ok"                # executed; ``Response.value`` holds the answer
    REJECTED = "rejected"    # admission control: queue full at submit
    TIMED_OUT = "timed_out"  # deadline expired while queued; not executed


@dataclasses.dataclass
class Request:
    """One single-query request (kind-specific payload + params).

    payload: (4,) f32 query box for range kinds, (2,) f32 point for
    knn.  params: () | (max_hits,) | (k, max_cand) — the static values
    a batch must share.  ``deadline`` is absolute (``inf`` = none).
    ``future`` is an opaque slot for the asyncio wrapper; the plane
    never touches it.
    """
    kind: str
    payload: Any
    params: tuple
    tenant: str = "default"
    arrival: float = 0.0
    deadline: float = float("inf")
    seq: int = -1
    future: Any = None
    formed: float = 0.0       # set when its batch closes


@dataclasses.dataclass
class Batch:
    """A closed batch: ``len(requests)`` real queries padded to
    ``width`` slots (a ladder rung) at execution time."""
    kind: str
    params: tuple
    requests: list
    width: int
    formed_at: float


@dataclasses.dataclass
class Response:
    """What a caller gets back for one request."""
    outcome: Outcome
    value: Any = None            # kind-specific answer when OK
    queue_s: float = 0.0         # arrival -> batch formed
    execute_s: float = 0.0       # batch formed -> results ready
    total_s: float = 0.0         # arrival -> response

    @property
    def ok(self) -> bool:
        return self.outcome is Outcome.OK


class _ClassQueue:
    """Pending requests of one (kind, params) class: FIFO per tenant
    plus the DRR rotation state."""

    def __init__(self):
        self.by_tenant: dict[str, deque] = {}
        self.rotation: deque = deque()       # tenant visit order (DRR)
        self.count = 0

    def push(self, req: Request) -> None:
        q = self.by_tenant.get(req.tenant)
        if q is None:
            q = self.by_tenant[req.tenant] = deque()
            self.rotation.append(req.tenant)
        q.append(req)
        self.count += 1

    def oldest_arrival(self) -> float:
        """Earliest arrival among per-tenant FIFO heads (== the
        earliest pending arrival, since each deque is FIFO)."""
        return min(q[0].arrival for q in self.by_tenant.values() if q)

    def take(self, n_max: int, quantum: int, now: float,
             expired: list) -> list:
        """Pop up to ``n_max`` live requests by deficit round robin:
        each rotation turn grants one tenant up to ``quantum``
        requests; already-expired requests are diverted to ``expired``
        and don't consume the grant.  The rotation deque persists
        across batches, so fairness holds stream-wide, not just within
        one batch."""
        take: list = []
        turns_left = len(self.rotation)
        while len(take) < n_max and self.count and turns_left:
            tenant = self.rotation[0]
            self.rotation.rotate(-1)
            q = self.by_tenant.get(tenant)
            granted = 0
            while q and granted < quantum and len(take) < n_max:
                req = q.popleft()
                self.count -= 1
                if req.deadline < now:
                    expired.append(req)
                else:
                    take.append(req)
                    granted += 1
            # a tenant that still has backlog stays in rotation and
            # will be revisited after everyone else had a turn
            turns_left = turns_left - 1 if granted < quantum or not q \
                else len(self.rotation)
        self.rotation = deque(t for t in self.rotation if self.by_tenant[t])
        for t in [t for t, q in self.by_tenant.items() if not q]:
            del self.by_tenant[t]
        return take


class RequestPlane:
    """The deterministic admission + batching state machine (see
    module docstring).  Not thread-safe by design: drive it from one
    thread/loop and hand closed batches to an executor."""

    def __init__(self, config: FrontendConfig | None = None,
                 metrics: FrontendMetrics | None = None):
        self.config = config or FrontendConfig()
        self.metrics = metrics or FrontendMetrics()
        self._classes: dict[tuple, _ClassQueue] = {}
        self._seq = itertools.count()

    # -- introspection ----------------------------------------------------

    @property
    def pending(self) -> int:
        return sum(c.count for c in self._classes.values())

    # -- admission --------------------------------------------------------

    def submit(self, req: Request, now: float) -> bool:
        """Admit ``req`` (True) or reject it under backpressure
        (False).  Fills ``arrival``/``seq``; applies the config's
        default deadline budget when the request carries none."""
        if req.kind not in KINDS:
            raise ValueError(f"unknown request kind {req.kind!r}; "
                             f"expected one of {KINDS}")
        req.arrival = now
        req.seq = next(self._seq)
        if req.deadline == float("inf") and \
                self.config.default_deadline is not None:
            req.deadline = now + self.config.default_deadline
        if self.pending >= self.config.queue_limit:
            self.metrics.on_submit(req.tenant, False, self.pending)
            return False
        key = (req.kind, tuple(req.params))
        cq = self._classes.get(key)
        if cq is None:
            cq = self._classes[key] = _ClassQueue()
        cq.push(req)
        self.metrics.on_submit(req.tenant, True, self.pending)
        return True

    # -- batch forming ----------------------------------------------------

    def _due(self, cq: _ClassQueue, now: float) -> bool:
        # the same expression next_due() reports, so a loop that
        # sleeps until next_due() always finds the batch formable
        # (now - oldest >= max_delay differs from this by 1 ulp)
        return cq.count >= self.config.max_batch or (
            cq.count > 0
            and cq.oldest_arrival() + self.config.max_delay <= now)

    def next_due(self, now: float) -> float | None:
        """Earliest instant a batch will be due (<= now when one is
        already formable; None when the plane is empty)."""
        t = None
        for cq in self._classes.values():
            if not cq.count:
                continue
            if cq.count >= self.config.max_batch:
                return now
            due = cq.oldest_arrival() + self.config.max_delay
            t = due if t is None else min(t, due)
        return t

    def form_batch(self, now: float, force: bool = False
                   ) -> tuple[Batch | None, list]:
        """Close and return the most overdue due batch, plus every
        request that timed out on the way into it.

        Returns ``(batch, expired)``; batch is None when nothing is
        due (``force=True`` closes the oldest non-empty class
        regardless — the drain path).  Expired requests have been
        counted in metrics; the caller owns responding to them.
        """
        due = [(key, cq) for key, cq in self._classes.items()
               if cq.count and (force or self._due(cq, now))]
        expired: list = []
        while due:
            due.sort(key=lambda kc: kc[1].oldest_arrival())
            key, cq = due[0]
            take = cq.take(self.config.max_batch, self.config.quantum,
                           now, expired)
            if not cq.count:
                del self._classes[key]
                due.pop(0)
            if take:
                for r in take:
                    r.formed = now
                for r in expired:
                    self.metrics.on_timeout(r.tenant)
                batch = Batch(kind=key[0], params=key[1], requests=take,
                              width=self.config.width_for(len(take)),
                              formed_at=now)
                self.metrics.on_batch(batch.width, len(take), self.pending)
                return batch, expired
            # every popped request of this class had expired: move on
            # to the next due class rather than returning empty-handed
            if cq.count:
                due[0] = (key, cq)
        for r in expired:
            self.metrics.on_timeout(r.tenant)
        return None, expired
