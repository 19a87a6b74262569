"""Deterministic synthetic token pipeline, host-sharded (twin of
``repro.data.tokens``).

Each data-parallel host draws only its shard of the global batch
(``host_id`` of ``n_hosts``) from a counter-based generator: a
``torch.Generator`` seeded from ``(seed, step, host_id)``, so any host
re-derives any shard (an elastic restart at step N regenerates exactly
the shard it owns).  The draw is made on the CPU and moved, so the
tokens do not depend on the device.  ``jax.random`` bits cannot be
reproduced here: the port's tokens are its own, and tests that hold it
to the reference share their arrays.

``doc_lengths`` is numpy in both packages and equal bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0


def step_seed(seed: int, step: int, host_id: int) -> int:
    """A 63-bit generator seed from the (seed, step, host) counter."""
    state = np.random.SeedSequence([seed, step, host_id]).generate_state(
        1, np.uint64)
    return int(state[0]) >> 1


def batch_for_step(cfg: TokenPipelineConfig, step: int, device=None,
                   dtype=torch.int32) -> dict:
    """The host's shard of the step's global batch: (B/H, S) of
    ``dtype`` (int32 or int64) on ``device`` (the CPU if None)."""
    per_host = cfg.global_batch // cfg.n_hosts
    gen = torch.Generator().manual_seed(step_seed(cfg.seed, step,
                                                  cfg.host_id))
    toks = torch.randint(0, cfg.vocab, (per_host, cfg.seq_len),
                         generator=gen, dtype=torch.int64)
    return {"tokens": toks.to(device=device, dtype=dtype)}


def doc_lengths(seed: int, n_docs: int, max_len: int) -> np.ndarray:
    """Heavy-tailed document lengths (lognormal, clipped)."""
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(mean=5.5, sigma=1.2, size=n_docs)
    return np.clip(raw.astype(np.int64), 16, max_len)
