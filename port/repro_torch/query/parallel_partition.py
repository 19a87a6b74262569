"""MapReduce-style parallel spatial partitioning (paper section 5.1,
Algorithm 7; twin of ``repro.query.parallel_partition``).

TeraSort-analogue over ``D`` buckets:
  sample  -- an anchor sample's Hilbert-key quantiles are the coarse
             splitters (the paper's anchor point list);
  map     -- every object is keyed by the Hilbert value of its centre
             (one encode launch over all of them) and given a coarse
             bucket by ``searchsorted``;
  shuffle -- each of the ``D`` source devices fills padded per-bucket
             send buffers; the reference's ``all_to_all`` is a
             transpose of the ``(D, D, cap)`` buffers here;
  reduce  -- each bucket runs a fine partitioner (masked SLC), all ``D``
             at once; the union of the bucket layouts is the layout.

Without a mesh the ``D`` devices are simulated on one.  Under a process
mesh (``launch.mesh``, ``D`` ranks) rank ``s`` maps source block ``s``,
the shuffle is an ``all_to_all_single`` of its send buffers, it reduces
bucket ``s``, and an ``all_gather`` of the bucket layouts and an
all-reduced ``dropped`` give every rank the whole result, the
simulation's bits.  Like the paper's, the parallel layout differs from
the single-threaded one but is "reasonably well"; the same metrics
measure it.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import geometry
from ..core.partition.api import Partitioning
from ..kernels.hilbert import ops as hilbert_ops

BIG = 3.4e38   # float32 stand-in for +inf in the masked reductions


def coarse_splitters(mbrs: torch.Tensor, n_buckets: int, sample: int = 4096,
                     seed: int = 0) -> torch.Tensor:
    """Anchor-sample Hilbert quantiles -> (n_buckets-1,) int64 splitters
    (the uint32 key values).

    The sample is drawn without replacement from a seeded generator on
    the objects' device (the reference draws from a ``jax.random`` key,
    whose bits cannot be reproduced: parity tests pass its splitters
    across), and the quantile positions are rounded half to even, not
    truncated.
    """
    n = mbrs.shape[0]
    g = torch.Generator(device=mbrs.device).manual_seed(seed)
    idx = torch.randperm(n, generator=g, device=mbrs.device)[:min(sample, n)]
    keys = torch.sort(hilbert_ops.hilbert_keys(
        geometry.centroids(mbrs[idx]), geometry.universe(mbrs))).values
    q = np.round(np.linspace(0, keys.shape[0] - 1, n_buckets + 1)[1:-1])
    return keys[torch.from_numpy(q.astype(np.int64)).to(mbrs.device)]


def _slc_masked(local_mbrs: torch.Tensor, real: torch.Tensor, payload: int,
                kmax: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked strip partitioner for padded reducer buckets.

    local_mbrs (..., L, 4), real (..., L) -> ``(boxes[..., kmax, 4]
    f32, valid[..., kmax])``: each bucket's real objects sorted by
    x-centroid (padding to the float32 ``BIG``) and sliced into strips
    of ``payload``, cut at the midpoints; a strip's y-extent is the
    bucket's tight y-range; boxes past the bucket's strips are 0.
    """
    big = torch.tensor(BIG, dtype=torch.float32, device=local_mbrs.device)
    cx = torch.where(real, (local_mbrs[..., 0] + local_mbrs[..., 2]) * 0.5,
                     big)
    cx_s = torch.sort(cx, dim=-1, stable=True).values
    m = real.sum(-1, keepdim=True)
    y0 = torch.where(real, local_mbrs[..., 1], big).amin(-1, keepdim=True)
    y1 = torch.where(real, local_mbrs[..., 3], -big).amax(-1, keepdim=True)
    x0 = torch.where(real, local_mbrs[..., 0], big).amin(-1, keepdim=True)
    x1 = torch.where(real, local_mbrs[..., 2], -big).amax(-1, keepdim=True)

    nn = cx_s.shape[-1]
    i = torch.arange(kmax, device=local_mbrs.device)
    lo_i = (i * payload).clamp(0, nn - 1)
    hi_i = ((i + 1) * payload).clamp(0, nn - 1)

    def mid(j):
        return (cx_s[..., j] + cx_s[..., (j - 1).clamp_min(0)]) * 0.5

    lo_v = torch.where(i == 0, x0, mid(lo_i))
    hi_v = torch.where((i + 1) * payload >= m, x1, mid(hi_i))
    valid = (i * payload) < m
    boxes = torch.stack([lo_v, y0.expand_as(lo_v), hi_v, y1.expand_as(lo_v)],
                        dim=-1)
    return torch.where(valid[..., None], boxes, 0.0).to(torch.float32), valid


def parallel_partition(mbrs: torch.Tensor, payload: int, n_devices: int,
                       mesh=None, cap_factor: float = 2.0,
                       *, splitters: torch.Tensor | None = None,
                       seed: int = 0) -> tuple[Partitioning, dict]:
    """Two-level partitioning over ``n_devices`` devices, simulated on
    one or, under ``mesh``, one a rank (``n_devices`` must be the mesh
    size; every rank passes the same ``mbrs``).

    mbrs (N, 4) f32 -> ``(Partitioning, stats)``: ``D·kmax_local·D``
    regions (each bucket's ``kmax_local·D`` strips, valid where a strip
    holds objects) and ``stats = dict(dropped, buckets, kmax_local)``.
    Device ``s`` holds objects ``s·ceil(N/D) ..``, each bucket's
    buffer holds ``cap = ceil(cap_factor·N/D)`` objects from each
    source and ``dropped`` counts the objects past it.  ``splitters``
    ((D-1,) Hilbert keys) replaces the sampled ``coarse_splitters``
    (the same seeded sample on every rank).
    """
    d = max(1, int(n_devices))
    if mesh is not None and mesh.size != d:
        raise ValueError(f"{d} devices on a mesh of {mesh.size} ranks")
    dev = mbrs.device
    n = mbrs.shape[0]
    per_dev = math.ceil(n / d)
    cap = math.ceil(cap_factor * per_dev)
    kmax_local = max(1, math.ceil(cap / payload))

    if splitters is None:
        splitters = coarse_splitters(mbrs, d, seed=seed)
    splitters = torch.as_tensor(splitters, device=dev).to(torch.int64)
    uni = geometry.universe(mbrs)
    sentinel = geometry.sentinel(dev)
    mbrs_p = torch.cat([mbrs.to(torch.float32),
                        sentinel.expand(d * per_dev - n, 4)])
    real = torch.arange(d * per_dev, device=dev) < n
    src = torch.arange(d * per_dev, device=dev) // per_dev
    sources = d
    if mesh is not None:
        # the rank maps its own source block only
        block = slice(mesh.rank * per_dev, (mesh.rank + 1) * per_dev)
        mbrs_p, real = mbrs_p[block], real[block]
        src = torch.zeros_like(src[block])
        sources = 1

    # map: every object's Hilbert key -> coarse bucket
    keys = hilbert_ops.hilbert_keys(geometry.centroids(mbrs_p), uni)
    bucket = torch.searchsorted(splitters, keys)
    # send buffers (sources, D bucket, cap): a source's objects of one
    # bucket in their order, the first cap of them
    group = torch.where(real, src * d + bucket, sources * d)
    order = torch.sort(group, stable=True).indices
    sizes = torch.bincount(group, minlength=sources * d + 1)
    start = torch.cumsum(sizes, 0) - sizes
    rank = torch.empty_like(group)
    rank[order] = torch.arange(order.shape[0], device=dev) - start[group[order]]
    ok = real & (rank < cap)
    send = sentinel.expand(sources, d, cap, 4).clone()
    smask = torch.zeros(sources, d, cap, dtype=torch.bool, device=dev)
    send[src[ok], bucket[ok], rank[ok]] = mbrs_p[ok]
    smask[src[ok], bucket[ok], rank[ok]] = True
    dropped = (real & ~ok).sum().view(1)
    # shuffle: bucket b receives every source's buffer b, in source order
    if mesh is None:
        recv = send.transpose(0, 1).reshape(d, d * cap, 4)
        rmask = smask.transpose(0, 1).reshape(d, d * cap)
    else:
        recv = mesh.all_to_all(send[0]).reshape(1, d * cap, 4)
        rmask = mesh.all_to_all(smask[0]).reshape(1, d * cap)
        dropped = mesh.all_reduce(dropped, "sum")
    # reduce: the fine partition of every bucket
    boxes, valid = _slc_masked(recv, rmask, payload, kmax_local * d)
    if mesh is not None:
        boxes, valid = mesh.all_gather(boxes[0]), mesh.all_gather(valid[0])
    stats = dict(dropped=int(dropped), buckets=d, kmax_local=kmax_local)
    return Partitioning(boxes=boxes.reshape(-1, 4),
                        valid=valid.reshape(-1)), stats
