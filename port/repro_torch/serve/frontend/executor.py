"""Execute one closed batch against the batched ``SpatialServer`` (twin
of ``repro.serve.frontend.executor``).

The bridge between the request plane and the serving engine: a
``Batch`` of single-query requests becomes ONE padded call to the
server's batched API — the same call a closed-loop caller would make —
so the front-end inherits every exactness guarantee (routing, the kNN
widen-and-retry ladder, canonical dedup) without re-implementing any
of it.  The server is used strictly through its public batched surface
and the ``TileLayout`` protocol underneath it, so the replicated,
sharded and heat placements are interchangeable backends here.

Padding: a batch of ``n`` requests runs at ladder width ``w >= n``.
Range pad rows are the sentinel box (intersects nothing: zero fan-out,
zero hits); kNN pad rows are the dataset-universe centre (the pad point
the sharded placement's own query packing uses).  Pad rows are sliced
off before responses are built.  Every per-request answer is a
function of that request's query alone — counts are exact sums, id
lists are exact ascending sets, kNN is exact with the (distance, id)
tie-break — so a padded batched response is **bit-identical** to
calling the batched API directly with the same queries.

The answers come back as host numpy (no response holds a device
tensor); the copies wait for the card, so a caller's clock around
``execute_batch`` measures the device's time and the host's together.
The call runs under ``torch.no_grad()`` set here: the worker thread of
``ServeFrontend`` does not inherit its caller's (thread-local) grad
mode.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core import geometry
from .plane import Batch

_SENTINEL = np.asarray(geometry.SENTINEL_BOX, np.float32)


def _padded(batch: Batch, pad_row: np.ndarray) -> np.ndarray:
    dim = pad_row.shape[0]
    out = np.broadcast_to(pad_row, (batch.width, dim)).copy()
    for i, req in enumerate(batch.requests):
        out[i] = np.asarray(req.payload, np.float32).reshape(dim)
    return out


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def execute_batch(server, batch: Batch) -> list:
    """Run ``batch`` through ``server``'s batched API; return one
    result per request (batch order).

    Per-request results: ``range_counts`` -> int count; ``range_ids``
    -> (ids (max_hits,) int32 ascending -1-padded, count, overflow
    bool); ``knn`` -> (nn_ids (k,) int32, nn_d2 (k,) f32, overflow
    bool).  Everything is host numpy.
    """
    with torch.no_grad():
        return _execute(server, batch)


def _execute(server, batch: Batch) -> list:
    n = len(batch.requests)
    if batch.kind == "knn":
        k, max_cand = batch.params
        uni = _host(server.uni).astype(np.float32)
        centre = (uni[:2] + uni[2:]) * 0.5
        pts = _padded(batch, centre)
        nn_ids, nn_d2, overflow, _ = server.knn(pts, k, max_cand=max_cand)
        nn_ids, nn_d2, overflow = _host(nn_ids), _host(nn_d2), _host(overflow)
        return [(nn_ids[i], nn_d2[i], bool(overflow[i])) for i in range(n)]

    qboxes = _padded(batch, _SENTINEL)
    if batch.kind == "range_counts":
        counts, _ = server.range_counts(qboxes)
        counts = _host(counts)
        return [int(counts[i]) for i in range(n)]
    if batch.kind == "range_ids":
        (max_hits,) = batch.params
        hit_ids, counts, overflow, _ = server.range_ids(
            qboxes, max_hits=max_hits)
        hit_ids, counts, overflow = (_host(hit_ids), _host(counts),
                                     _host(overflow))
        return [(hit_ids[i], int(counts[i]), bool(overflow[i]))
                for i in range(n)]
    raise ValueError(f"unknown batch kind {batch.kind!r}")
