"""Partitioner-based load-balanced batch packing (twin of
``repro.data.balanced``).

A token pipeline feeds variable-length documents to fixed-shape device
batches, and a skewed assignment leaves devices idle at every
lock-step collective: the paper's straggler argument.  Documents become
degenerate MBRs in (token position, length) space, one of the paper's
partitioners (SLC by default: strips of equal token payload) cuts them
into strips, and LPT packs the strips onto device bins; the balance is
reported as for spatial tiles.  The partition runs on ``device``
(``cuda`` unless ``"cpu"``), the packing on the host, as in the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.partition import api
from ..core.placement import lpt_pack
from ..device import resolve


def docs_as_mbrs(lengths: np.ndarray, device=None) -> torch.Tensor:
    """Documents -> point MBRs at (token-mass centre, length), float32
    on ``device``."""
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.float32)
    ln = lengths.astype(np.float32)
    x = starts + ln * 0.5          # token-mass coordinate
    return torch.from_numpy(np.stack([x, ln, x, ln], axis=-1)).to(
        resolve(device))


def _stats(lengths: np.ndarray, assignment: np.ndarray, n_bins: int) -> dict:
    bin_tokens = np.zeros(n_bins)
    np.add.at(bin_tokens, assignment, lengths)
    return {"skew": float(bin_tokens.max() / max(bin_tokens.mean(), 1e-9)),
            "stddev": float(bin_tokens.std())}


def balanced_bins(lengths: np.ndarray, n_bins: int, method: str = "slc",
                  device=None):
    """Assign documents to ``n_bins`` device bins of about equal token
    payload -> (bin of each document, {skew, stddev, makespan}): the
    partitioner's strips in token-mass space, a strip per document by
    the strips' cut positions, then LPT of the strips' tokens."""
    n = len(lengths)
    mbrs = docs_as_mbrs(lengths, device)
    parts = api.partition(method, mbrs, max(1, n // n_bins))
    boxes = parts.boxes.cpu().numpy()
    valid = parts.valid.cpu().numpy()
    x = mbrs[:, 0].cpu().numpy()
    order = np.argsort(boxes[:, 0])
    order = order[valid[order]]
    cuts = boxes[order, 0]
    strip = np.clip(np.searchsorted(cuts, x, side="right") - 1, 0,
                    len(order) - 1)
    strip_tokens = np.zeros(len(order))
    np.add.at(strip_tokens, strip, lengths)
    sbin, makespan, _ = lpt_pack(strip_tokens, n_bins)
    assignment = sbin[strip]
    return assignment, {**_stats(lengths, assignment, n_bins),
                        "makespan": makespan}


def naive_bins(lengths: np.ndarray, n_bins: int):
    """Round-robin baseline (what a plain dataloader does)."""
    assignment = np.arange(len(lengths)) % n_bins
    return assignment, _stats(lengths, assignment, n_bins)
