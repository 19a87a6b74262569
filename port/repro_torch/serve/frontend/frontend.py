"""``ServeFrontend``: the asyncio wrapper around the sans-IO request
plane (twin of ``repro.serve.frontend.frontend``).

Callers await single-query coroutines (``range_counts`` /
``range_ids`` / ``knn``); one background dispatcher task forms batches
by the plane's deadline-or-full rule and runs them on a single worker
thread (``execute_batch`` calls block on device sync, and the engine's
width-policy cache is not thread-safe — one executor thread is the
concurrency model).  torch's grad mode and current stream are
thread-local: the executor sets its own grad mode, and the worker's
launches go to the default stream, as the caller's would.  Results
come back as ``Response`` objects; rejected and timed-out requests
resolve with their outcome instead of raising, so SLO handling is
explicit at the call site.

The wrapper adds *only* IO: futures, a wake event, the worker thread,
and wall-clock ``now``.  All policy (admission, fairness, deadlines,
batch shapes) lives in ``RequestPlane`` and is covered by the
virtual-clock tests.
"""
from __future__ import annotations

import asyncio
import concurrent.futures

import numpy as np

from .clock import MonotonicClock
from .config import FrontendConfig
from .executor import execute_batch
from .metrics import FrontendMetrics
from .plane import Outcome, RequestPlane, Request, Response


class ServeFrontend:
    """Async facade over one ``SpatialServer`` (any ``TileLayout``
    placement).  Use as an async context manager, or call ``start()`` /
    ``await close()`` explicitly."""

    def __init__(self, server, config: FrontendConfig | None = None):
        self.server = server
        self.config = config or FrontendConfig()
        self.metrics = FrontendMetrics()
        self.plane = RequestPlane(self.config, self.metrics)
        self.clock = MonotonicClock()
        self._wake: asyncio.Event | None = None
        self._task: asyncio.Task | None = None
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._closing = False

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "ServeFrontend":
        if self._task is not None:
            return self
        self._closing = False
        self._wake = asyncio.Event()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-frontend")
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def close(self) -> None:
        """Drain pending requests, then stop the dispatcher."""
        if self._task is None:
            return
        self._closing = True
        self._wake.set()
        await self._task
        self._task = None
        self._pool.shutdown(wait=True)
        self._pool = None

    async def __aenter__(self) -> "ServeFrontend":
        return self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- submission -------------------------------------------------------

    async def _submit(self, kind: str, payload: np.ndarray, params: tuple,
                      tenant: str, deadline: float | None) -> Response:
        if self._task is None:
            raise RuntimeError("ServeFrontend is not started")
        now = self.clock.now()
        req = Request(kind=kind, payload=payload, params=params,
                      tenant=tenant,
                      deadline=now + deadline if deadline is not None
                      else float("inf"))
        req.future = asyncio.get_running_loop().create_future()
        if not self.plane.submit(req, now):
            return Response(Outcome.REJECTED)
        self._wake.set()
        return await req.future

    async def range_counts(self, qbox, *, tenant: str = "default",
                           deadline: float | None = None) -> Response:
        """Count objects intersecting one (4,) query box.
        ``Response.value`` is an int."""
        return await self._submit(
            "range_counts", np.asarray(qbox, np.float32).reshape(4), (),
            tenant, deadline)

    async def range_ids(self, qbox, max_hits: int = 1024, *,
                        tenant: str = "default",
                        deadline: float | None = None) -> Response:
        """Ids of objects intersecting one (4,) query box.
        ``Response.value`` is ``(ids, count, overflow)``."""
        return await self._submit(
            "range_ids", np.asarray(qbox, np.float32).reshape(4),
            (int(max_hits),), tenant, deadline)

    async def knn(self, pt, k: int, max_cand: int = 1024, *,
                  tenant: str = "default",
                  deadline: float | None = None) -> Response:
        """k nearest objects to one (2,) point.  ``Response.value`` is
        ``(nn_ids, nn_d2, overflow)``."""
        return await self._submit(
            "knn", np.asarray(pt, np.float32).reshape(2),
            (int(k), int(max_cand)), tenant, deadline)

    # -- reporting --------------------------------------------------------

    def placement_stats(self) -> dict:
        """The served placement's heat view, as plain host values: what
        an operator of the async plane watches to decide (or audit) a
        ``server.rebalance()`` without reaching into the engine.
        Traffic through this frontend feeds the tracker exactly like
        direct batched calls — heat is observed at routing time."""
        srv = self.server
        stats = srv.stats
        out = dict(placement=stats.get("placement"),
                   shards=getattr(srv, "shards", 1),
                   heat_batches=srv.heat.batches,
                   heat_decay=srv.heat.decay)
        for key in ("replicated_tiles", "moved_tiles", "cut_before",
                    "cut_after", "placement_skew", "t_local"):
            if key in stats:
                out[key] = stats[key]
        return out

    # -- dispatcher -------------------------------------------------------

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            now = self.clock.now()
            due = self.plane.next_due(now)
            if due is None:
                if self._closing:
                    return
                self._wake.clear()
                # re-check under the cleared event: a submit between
                # next_due() and clear() would otherwise be missed
                if self.plane.next_due(self.clock.now()) is None:
                    await self._wake.wait()
                continue
            if due > now and not self._closing:
                # (closing drains at once: the reference waits each
                # pending class out to its max_delay first)
                try:
                    await asyncio.wait_for(self._wake.wait(), due - now)
                    self._wake.clear()
                except asyncio.TimeoutError:
                    pass
                continue
            batch, expired = self.plane.form_batch(now, force=self._closing)
            self._finish_expired(expired, self.clock.now())
            if batch is None:
                continue
            try:
                results = await loop.run_in_executor(
                    self._pool, execute_batch, self.server, batch)
            except Exception as e:  # surface executor faults to callers
                for req in batch.requests:
                    if req.future is not None and not req.future.done():
                        req.future.set_exception(e)
                continue
            done = self.clock.now()
            for req, val in zip(batch.requests, results):
                queue_s = batch.formed_at - req.arrival
                execute_s = done - batch.formed_at
                self.metrics.on_complete(req.tenant, queue_s, execute_s,
                                         done - req.arrival)
                if req.future is not None and not req.future.done():
                    req.future.set_result(Response(
                        Outcome.OK, value=val, queue_s=queue_s,
                        execute_s=execute_s, total_s=done - req.arrival))

    def _finish_expired(self, expired, now: float) -> None:
        for req in expired:
            if req.future is not None and not req.future.done():
                req.future.set_result(Response(
                    Outcome.TIMED_OUT, queue_s=now - req.arrival,
                    total_s=now - req.arrival))
