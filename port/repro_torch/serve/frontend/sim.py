"""Deterministic open-loop simulator: seeded arrivals through the request
plane on a virtual clock (twin of ``repro.serve.frontend.sim``: the
same seeded arrivals and the same plane decisions).

Open-loop load (arrivals keep coming regardless of completions — the
production regime, where millions of users don't wait for each other)
is awkward to measure reliably on a shared CI machine with real
sleeps.  This simulator makes the queueing math exact instead: arrivals
follow a *seeded* Poisson process on a ``VirtualClock``, the plane's
admission/batching/timeout decisions replay bit-for-bit run over run,
and only batch *service* times come from the real machine (measured
around ``execute_batch`` and injected into virtual time — the
single-server model: while a batch executes, arrivals queue).  On the
card that service time is the device's and the host's together: the
executor copies every answer to the host, which waits for the card.
Tests swap the executor for a fixed-service-time stub and become fully
deterministic end to end.

``simulate_open_loop`` returns per-request ``Response``s (submission
order) plus the metrics sink — p50/p99 queue/total latency and
sustained QPS under a given offered load.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .clock import VirtualClock
from .config import FrontendConfig
from .executor import execute_batch
from .metrics import FrontendMetrics
from .plane import Outcome, RequestPlane, Request, Response


@dataclasses.dataclass
class Arrival:
    """One scheduled request of the open-loop workload."""
    t: float
    kind: str
    payload: np.ndarray
    params: tuple = ()
    tenant: str = "default"
    deadline: float | None = None     # relative budget (seconds)


def poisson_workload(rate: float, duration: float, make_request,
                     seed: int = 0) -> list[Arrival]:
    """Seeded Poisson arrivals at ``rate``/s over ``duration`` s.

    ``make_request(rng, i)`` -> ``(kind, payload, params, tenant)`` for
    the i-th arrival — the workload mix (query kinds, tenant skew) is
    the caller's, the arrival process is exponential inter-arrivals
    from one seeded generator, so a given (rate, duration, seed) is one
    reproducible trace.
    """
    rng = np.random.default_rng(seed)
    out: list[Arrival] = []
    t = 0.0
    i = 0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= duration:
            return out
        kind, payload, params, tenant = make_request(rng, i)
        out.append(Arrival(t=t, kind=kind, payload=payload,
                           params=tuple(params), tenant=tenant))
        i += 1


def simulate_open_loop(server, workload: list[Arrival],
                       config: FrontendConfig | None = None,
                       execute=None, clock: VirtualClock | None = None
                       ) -> tuple[list[Response], FrontendMetrics]:
    """Drive ``workload`` through a ``RequestPlane`` in virtual time.

    ``execute(server, batch) -> (results, service_s)`` defaults to the
    real ``execute_batch`` with wall-clock-measured service time; pass
    a stub for fully deterministic tests.  Returns one ``Response``
    per workload entry (same order; rejected/timed-out entries carry
    their outcome and no value).
    """
    config = config or FrontendConfig()
    clock = clock or VirtualClock()
    metrics = FrontendMetrics()
    plane = RequestPlane(config, metrics)
    if execute is None:
        def execute(srv, batch):
            t0 = time.perf_counter()
            results = execute_batch(srv, batch)
            return results, time.perf_counter() - t0

    responses: list[Response | None] = [None] * len(workload)
    index_of: dict[int, int] = {}          # plane seq -> workload index
    i = 0
    inf = float("inf")

    def submit_due():
        nonlocal i
        now = clock.now()
        while i < len(workload) and workload[i].t <= now:
            a = workload[i]
            req = Request(kind=a.kind, payload=a.payload, params=a.params,
                          tenant=a.tenant)
            if a.deadline is not None:
                req.deadline = a.t + a.deadline
            # submit at the arrival's own timestamp: queueing delay is
            # measured from when the request arrived, not from when the
            # simulation loop got around to it
            if plane.submit(req, a.t):
                index_of[req.seq] = i
            else:
                responses[i] = Response(Outcome.REJECTED)
            i += 1

    def resolve_expired(expired):
        for r in expired:
            responses[index_of[r.seq]] = Response(
                Outcome.TIMED_OUT, queue_s=clock.now() - r.arrival,
                total_s=clock.now() - r.arrival)

    while i < len(workload) or plane.pending:
        submit_due()
        next_arrival = workload[i].t if i < len(workload) else inf
        due = plane.next_due(clock.now())
        next_event = min(next_arrival, due if due is not None else inf)
        if next_event > clock.now():
            if next_event == inf:      # arrivals done, queue not due yet
                batch, expired = plane.form_batch(clock.now(), force=True)
                resolve_expired(expired)
                if batch is None:
                    break
                _run_batch(server, batch, execute, clock, metrics,
                           responses, index_of)
                continue
            clock.advance_to(next_event)
            submit_due()
        batch, expired = plane.form_batch(clock.now())
        resolve_expired(expired)
        if batch is not None:
            _run_batch(server, batch, execute, clock, metrics,
                       responses, index_of)
    return [r if r is not None else Response(Outcome.TIMED_OUT)
            for r in responses], metrics


def _run_batch(server, batch, execute, clock, metrics, responses,
               index_of) -> None:
    results, service_s = execute(server, batch)
    clock.advance(max(float(service_s), 0.0))
    done = clock.now()
    for req, val in zip(batch.requests, results):
        queue_s = batch.formed_at - req.arrival
        execute_s = done - batch.formed_at
        metrics.on_complete(req.tenant, queue_s, execute_s,
                            done - req.arrival)
        responses[index_of[req.seq]] = Response(
            Outcome.OK, value=val, queue_s=queue_s, execute_s=execute_s,
            total_s=done - req.arrival)
