"""repro's side of a test module's cases, computed ahead in threads.

Most of a parity test's time is repro's: XLA compiles each new shape,
and the compiler runs outside the GIL.  ``References(jobs)`` (a dict of
a case's key to a function of no arguments) starts every job of a
module in ``THREADS`` threads when the first case asks for its own, so
the compiles of the later cases overlap; each case then waits for its
result.  A job returns plain numpy and Python values copied out of
repro's objects, so the cases share nothing mutable.  A case run alone
(``-k``) still computes every job of its module.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

THREADS = 3


class References:
    def __init__(self, jobs: dict):
        self.jobs, self.futs = jobs, None

    def __getitem__(self, key):
        if self.futs is None:
            pool = ThreadPoolExecutor(THREADS)
            self.futs = {k: pool.submit(job) for k, job in self.jobs.items()}
            pool.shutdown(wait=False)
        return self.futs[key].result()
