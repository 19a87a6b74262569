"""Fault-tolerant training runtime (twin of ``repro.ft.runtime``).

The recovery contract is the standard one:
  * checkpoint every ``ckpt_every`` steps (atomic, logical shapes),
  * on a step failure, restore the latest checkpoint and resume (or
    retry the step where there is none yet),
  * step-time watchdogs only flag stragglers: a step's work cannot be
    reassigned while it runs.

``run_loop`` is host-driven and synchronous: it is the control plane,
the train step is the data plane.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable

from ..checkpoint import store

log = logging.getLogger("repro_torch.ft")


@dataclasses.dataclass
class FTConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 3
    straggler_factor: float = 3.0   # step-time watchdog threshold


class StepFailure(RuntimeError):
    pass


def run_loop(step_fn: Callable, state, batches, cfg: FTConfig,
             map_location=None, inject_failure_at: int | None = None,
             shardings=None):
    """Run ``step_fn`` over ``batches`` with checkpoint and restart.

    ``inject_failure_at``: test hook, raises StepFailure once at that
    step to exercise the restart path.  ``shardings``: a
    ``dist.parallel.StateSpecs`` under a mesh (every rank runs the loop
    alike); checkpoints are written and restored through it, onto
    whatever mesh it names.
    """
    start = store.latest_step(cfg.ckpt_dir)
    step = 0
    if start is not None:
        state, step = store.restore(cfg.ckpt_dir, state,
                                    map_location=map_location,
                                    shardings=shardings)
        log.info("resumed from step %d", step)

    restarts = 0
    times: list[float] = []
    metrics = None
    injected = False
    pending = list(enumerate(batches))
    i = 0
    while i < len(pending):
        gstep = step + i
        _, batch = pending[i]
        t0 = time.perf_counter()
        try:
            if inject_failure_at is not None and gstep == inject_failure_at \
                    and not injected:
                injected = True
                raise StepFailure(f"injected node failure at step {gstep}")
            state, metrics = step_fn(state, batch)
        except StepFailure as e:
            restarts += 1
            if restarts > cfg.max_restarts:
                raise
            log.warning("step %d failed (%s); restarting from checkpoint",
                        gstep, e)
            last = store.latest_step(cfg.ckpt_dir)
            if last is not None:
                state, ck = store.restore(cfg.ckpt_dir, state,
                                          map_location=map_location,
                                          shardings=shardings)
                i = ck - step
            continue
        dt = time.perf_counter() - t0
        if times and dt > cfg.straggler_factor * (sum(times) / len(times)):
            log.warning("straggler step %d: %.3fs vs mean %.3fs",
                        gstep, dt, sum(times) / len(times))
        times.append(dt)
        if (gstep + 1) % cfg.ckpt_every == 0:
            store.save(cfg.ckpt_dir, state, gstep + 1, shardings)
        i += 1
    return state, metrics, {"restarts": restarts, "steps": len(pending),
                            "mean_step_s": sum(times) / max(len(times), 1)}
