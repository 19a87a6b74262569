"""Async request plane in front of ``SpatialServer`` (twin of
``repro.serve.frontend``, the same names).

Single-query requests go in; deadline-or-full padded batches come out
the back into the server's batched API, with admission control and
per-tenant fairness in between.  The policy core (``RequestPlane``) is
sans-IO and clock-explicit; ``ServeFrontend`` is the asyncio wrapper,
``sim`` the deterministic open-loop simulator.  See
``docs/ARCHITECTURE.md`` ("Request plane").
"""
from .clock import MonotonicClock, VirtualClock
from .config import FrontendConfig
from .executor import execute_batch
from .frontend import ServeFrontend
from .metrics import FrontendMetrics, Histogram
from .plane import KINDS, Batch, Outcome, Request, RequestPlane, Response
from .sim import Arrival, poisson_workload, simulate_open_loop

__all__ = [
    "Arrival",
    "Batch",
    "FrontendConfig",
    "FrontendMetrics",
    "Histogram",
    "KINDS",
    "MonotonicClock",
    "Outcome",
    "Request",
    "RequestPlane",
    "Response",
    "ServeFrontend",
    "VirtualClock",
    "execute_batch",
    "poisson_workload",
    "simulate_open_loop",
]
