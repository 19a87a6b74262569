#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's serving, partitioning and join paths
on one CUDA card.

    python3 chip_smoke.py            # full size: 8 M osm-like objects served,
                                     # 4 M + 4 M pi and 1 M + 1 M osm joined,
                                     # Mamba2-1.3B prefill and decode

Phases, each printing JSON lines (launch counts are set to 0 just
before each path and read just after it) and its wall seconds:

1. build  -- compile the four kernel sources of the checkout (range
   probe, Hilbert encode, MBR join, SSD) with one nvcc each, all at
   once (sm_90a), and report the compiler's register/spill summary.
2. serve  -- with every kernel launch count at 0: generate N osm-like
   objects on the card (seeded), partition them with ``bsp`` at payload
   4096 and stage them three times (``local_index="x"``, ``"off"`` and
   ``"hilbert"``, whose staging runs the Hilbert encode over every
   slot), then serve 20 ``range_counts`` batches of Q = 4096 boxes
   (centres uniform, half-extents uniform in [0, 0.03]) and 5
   ``range_ids`` batches of 1024 boxes (half-extents in [0, 0.003],
   max_hits = 1024) through each server.  Counts and ids of "x",
   "hilbert" and "off" must be equal; 1024 queries of the first counts
   batch and every query of the first ids batch are checked against a
   blocked brute force on the card, overflow flags included.  The
   launch counts are read right after: the routed counts and the
   routed hit lists must have launched, the routed hit-table kernels
   not at all.
3. knn    -- 5 batches of 1024 points (uniform in the unit square,
   k = 10, max_cand = 1024) through the "x", "off" and "hilbert"
   servers' pruned kNN, the widen-and-retry ladder included.  "off" and
   "hilbert" must flag the same points as "x" and equal it bit for bit
   (ids, d2) on every unflagged point, and 256 points of the first
   batch must equal an on-card brute force by (d2, id) over all N
   objects, d2 rounded as the executors round it (``mindist2_fused``).  A point flagged for
   more than max_cand candidates keeps the first max_cand hits in
   (tile, slot) order, as repro does, and the stagings order slots
   differently, so its answer is the staging's own.  The gathered
   kernels' launch counts are read right after (hit lists launched, no
   hit table).
4. dense  -- the dense oracle (``pruned=False``) on the "x" server,
   on whole batches: range_counts on the first counts batch (Q =
   4096), range_ids and knn on the first ids and kNN batches (1024
   rows each), three timed calls each plus one profiled (device time,
   the five largest items, peak memory), and range_ids and knn on
   their first 256 rows as well (the size earlier runs timed).  Each
   must equal the pruned answer bit for bit (kNN: on every point that
   neither side flags) and the on-card brute force (1024 counts, every
   ids query, 256 kNN points the dense side does not flag): the oracle
   and the pruned path share the tile-major probe.  The launch counts
   are read right after: ``dense_counts`` and ``dense_hits`` must have
   launched, the block-per-tile ``count`` and ``mask`` not at all.
5. kernels -- each of the range-probe kernels against its plain
   PyTorch version on the card, at the shapes its path gives it
   (routed counts: a routed counts batch; routed hit lists: the ids
   batch whole and one kNN refinement call at its own radii; routed
   tables: the old ids executor's largest hit-table block; dense
   counts: the Q = 4096 counts batch; the dense hit list: the ids
   batch whole and the dense kNN's refinement; dense tables: the old
   dense executor's hit-table block): the path's own inputs (staged
   alive mask, bounding chunk boxes), then ``alive`` None and a random
   mask and, for the skip kernels, chunk boxes that do not bound their
   members; the count and hit list kernels take the live extent of
   each alive mask.  Results must be bit-equal.  The hit lists' rows
   give each stage's time (grouping, count, scan, emit) and the old
   extraction's on the same inputs (the table kernel and ``nonzero``
   over its blocks, which must give the same list), beside the table
   kernel's time.  Kernel times come from CUDA events, plain times
   from the host clock.  The count kernels are also timed without the
   extent (bit-equal), the dense counts also in the old
   block-per-(tile, query block) design (``count``, bit-equal), and
   their rows give the grouping pass's time and the bound over all of
   cap beside the bound at the extent.  The dense skip pair has no
   serving caller (repro launches it from tests only), so it is
   launched from this phase only and its row says so; in all six cases
   its new design (to the case's extent and without it) and its first
   design (``count_skip_v1``, ``mask_skip_v1``) are held to the plain
   version and timed in turns, the counts beside ``dense_counts`` on
   the same inputs.  No dense kernel's row may read faster than its
   own bound.
6. partition -- the six Table-1 partitioners on the join's merged pi
   input (8 M objects) at payload 4096: seconds, k, and the paper's
   lambda, balance stddev, skew and coverage; hc's encode launches.
7. join   -- ``plan_join`` then ``spatial_join_count`` for each of the
   six layouts on two inputs at payload 4096: pi |><| pi (4 M + 4 M
   ``pi_like``, seeds 0 and 1) and osm |><| osm (1 M + 1 M
   ``osm_like``, seeds 0 and 1).  Plan and join seconds are medians of
   3; the raw MASJ count comes from ``tile_counts(dedup="none")``'s
   per-tile counts, which must be one batched raw count launch and no
   ``count`` launch, and whose largest value sets
   ``max_pairs_per_tile``, so no tile's pairs are truncated; the raw
   count is also timed (median of 3 ``run_join_count(dedup="none")``)
   and held, tile for tile, to the per-tile path it replaced (the
   ``count`` kernel a tile, ``join.tile_join_count(dedup="none")``),
   whose launches are not counted.  The MASJ pair path runs for every
   layout.  Each ``spatial_join_count`` must launch the batched rp count
   once (fg, bsp, slc, bos) or the batched pair list once (str, hc),
   and neither the ``mask`` table kernel nor ``count``.  On the bsp and
   hc plans the per-tile table join (``mask``, ``rp_own_mask``, a sum or
   ``nonzero``) and the per-tile raw count run as yardsticks, timed
   (median of 3) beside the new ones and held to the same counts; their
   launches are not counted.  The kernels' launches are read right
   after: ``raw_counts``, ``rp_counts``, ``pair_list`` and ``encode``
   must have launched, ``count``, ``mask`` and ``encode_v1`` not at
   all.
8. join_check -- fails unless, on each input, all six exact counts are
   equal, rp equals MASJ pairs for the non-overlapping layouts, the
   exact count equals one unpartitioned ``join_count`` of the whole
   inputs (the count kernel over every pair), the partner counts of
   4096 sampled R objects in the deduplicated bsp pair list equal a
   plain brute force against all of S, the raw count is at least the
   exact count, and no tile was truncated.
9. kernels -- encode over the 8 M merged pi centroids and over 2^25
   seeded grid points (a "hilbert" staging's launch size), timed in
   turns with the plane-loop design (``encode_v1``) on the same inputs,
   both bit-equal to the plain version; its operation count per point
   from the built kernel's SASS (``cuobjdump``, the vector loop's
   instructions over its four points).  The count and mask kernels on
   the largest live tile of the pi and the osm bsp joins, the batched
   rp and raw counts on the whole pi and osm bsp plans and the batched
   pair list on the whole pi and osm hc plans, each against its plain
   version (bit-equal) and the batched passes also against the per-tile
   path (the same counts, the same pair list), CUDA-event ms over 10
   launches beside the plain ms, the old design's ms and the bound
   (four compares a live (r, s) test at 67 T/s, integer instructions at
   33.5 T/s, or the bytes).

10. lm_prefill -- the spatial phases' tensors freed, the published
   Mamba2-1.3B configuration (48 SSD blocks, d_model 2048, 64 heads of
   64, state 128, bf16 activations) with random float32 weights from a
   seeded generator on the card, TF32 off for matmuls (asserted):
   ``make_prefill_step`` on B = 4 prompts of L = 32,768 tokens (the
   ``prefill_32k`` length; batch cut from its global 32).  Median of 3
   seconds, tokens/s, peak memory, the SSD launches (one a layer),
   device ms, idle share and the five largest device items from the
   profiler.  Layer 0's SSD inputs are kept for the kernel check.
11. lm_decode -- the greedy loop of ``launch/serve.py`` at batch 128,
   prompt 32, gen 32: tokens/s, p50 and p99 step ms, the idle share of
   a profiled step.
12. lm_check -- fails unless (a) the SSD kernel equals its plain version
   (the einsum form, run in blocks of chunks) within rtol = atol =
   2e-5 on layer 0's prefill inputs and on a random set; (b) in
   float32 at full width and depth, B = 2, L = 200 (the pad path), the
   teacher-forced logits through the kernel equal 200 ``decode_step``
   calls through the recurrence (which launch no kernel) within 1e-4,
   greedy tokens agreeing wherever the top-two margin exceeds it; (c)
   the prefill path launched the kernel once a layer, and the FFMA
   design never.  Then the kernel's CUDA-event ms over 10 launches at
   the prefill shape, timed in turns with the FFMA design on the same
   inputs, its plain ms and its bound.

Then one ``{"kernels": [...]}`` line (all twelve kernels and the
join's two batched passes), the card's
name and power limit as ``nvidia-smi`` prints them, and ``{"ok": true,
"device": ...}`` as the last line.  Any failure raises and the script
exits non-zero.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "port"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
# H100 SXM5, INT32 outside the tensor cores (NVIDIA's H100 white paper):
# the Hilbert encode's integer instructions are counted against it
INT_OPS_PER_S = 33.5e12
PAYLOAD, MAX_HITS, SEED = 4096, 1024, 0
N = 8_000_000          # osm-like objects served
Q, Q_IDS = 4096, 1024  # boxes per range_counts / range_ids batch
BATCHES, ID_BATCHES = 20, 5
CHECK_Q = 1024         # queries of the first counts batch brute-forced
Q_KNN, KNN_BATCHES, K, MAX_CAND = 1024, 5, 10, 1024
CHECK_KNN = 256        # points of the first kNN batch brute-forced
DENSE_ROWS = 256       # rows of the dense calls earlier runs timed
STAGINGS = ("x", "off", "hilbert")
INDEXED = ("x", "hilbert")  # stagings probed by the *_skip kernels
METHODS = ("fg", "bsp", "slc", "bos", "str", "hc")
JOIN_INPUTS = {"pi": 4_000_000, "osm": 1_000_000}   # objects per side
JOIN_SAMPLE = 4096     # R objects whose partners are brute-forced
HILBERT_SLOTS = 1 << 25   # slots a "hilbert" staging encodes a launch
SOURCE = "port/repro_torch/kernels/range_probe/csrc/range_probe.cu"
HILBERT_SOURCE = "port/repro_torch/kernels/hilbert/csrc/hilbert.cu"
MBR_SOURCE = "port/repro_torch/kernels/mbr_join/csrc/mbr_join.cu"
TPU = "src/repro/kernels/range_probe/kernel.py"
CASES = {  # routed entry point on the serving path -> the TPU kernel
    "gather_count_skip": f"{TPU}:467",
    "gather_hits_skip": f"{TPU}:495",
    "gather_count": f"{TPU}:190",
    "gather_hits": f"{TPU}:215",
}
TABLES = {  # routed hit list -> the table kernel of the same TPU kernel
    "gather_hits_skip": "gather_mask_skip",
    "gather_hits": "gather_mask",
}
HIT_BYTES = 3 * 8      # a hit's (query, tile, slot), int64
PLAIN_TABLE = 80_000_000   # table bytes a block of the plain hit list (its
                           # gathered boxes and temporaries about 25x that)
DENSE_CASES = {  # dense entry point -> the TPU kernel it replaces
    "dense_counts": f"{TPU}:106",
    "dense_hits": f"{TPU}:126",
    "count_skip": f"{TPU}:329",
    "mask_skip": f"{TPU}:354",
}
DENSE_OLD = {  # dense path entry -> the block-per-tile kernel it replaced
    "dense_counts": "count",
    "dense_hits": "mask",
}
BF16_FLOPS_PER_S = 989e12     # H100 SXM, dense bf16 tensor cores
LM_ARCH = "mamba2_1p3b"
PREFILL_B, PREFILL_L = 4, 32_768   # prefill_32k's length; batch 32 -> 4
DECODE_B, DECODE_PROMPT, DECODE_GEN = 128, 32, 32   # decode_32k's batch
CHECK_B, CHECK_L = 2, 200          # float32 prefill-vs-decode check
SSD_TOL = 2e-5                     # the reference's kernel tolerance
LM_TOL = 1e-4                      # tests/test_models_smoke.py's
SSD_SOURCE = "port/repro_torch/kernels/ssd/csrc/ssd.cu"
SSD_TPU = "src/repro/kernels/ssd/kernel.py:41"
NEW_CASES = {  # the join's kernels -> the TPU kernel each replaces
    "hilbert_encode": "src/repro/kernels/hilbert/kernel.py:41",
    "mbr_count": "src/repro/kernels/mbr_join/kernel.py:49",
    "mbr_mask": "src/repro/kernels/mbr_join/kernel.py:67",
    "mbr_rp_counts": "src/repro/kernels/mbr_join/kernel.py:67",
    "mbr_raw_counts": "src/repro/kernels/mbr_join/kernel.py:49",
    "mbr_pair_list": "src/repro/kernels/mbr_join/kernel.py:67",
}
BATCHED = {  # the join's batched passes -> the layout whose plan drives it
    "mbr_rp_counts": "bsp",
    "mbr_raw_counts": "bsp",
    "mbr_pair_list": "hc",
}
PAIR_BYTES = 2 * 4     # a listed pair's (r_id, s_id), int32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def qboxes(torch, g, q: int, half: float, dev):
    c = torch.rand(q, 2, generator=g, device=dev)
    s = torch.rand(q, 2, generator=g, device=dev) * half
    return torch.cat([c - s, c + s], dim=-1)


def brute_hits(geometry, mbrs, q):
    """(B, 4) queries vs all objects -> (B, N) bool, closed boxes."""
    return geometry.intersects(q[:, None, :], mbrs[None, :, :])


def check_counts(torch, geometry, mbrs, q, counts, block=32):
    for i in range(0, q.shape[0], block):
        want = brute_hits(geometry, mbrs, q[i:i + block]).sum(
            1, dtype=torch.int32)
        if not torch.equal(want, counts[i:i + block]):
            raise AssertionError(f"range_counts disagree with brute force "
                                 f"in queries {i}..{i + block}")


def check_ids(torch, geometry, mbrs, q, hit_ids, counts, overflow,
              max_hits, block=32):
    n_over = 0
    for i in range(0, q.shape[0], block):
        hit = brute_hits(geometry, mbrs, q[i:i + block])
        b = hit.shape[0]
        true_n = hit.sum(1, dtype=torch.int32)
        row, col = hit.nonzero(as_tuple=True)          # ascending ids
        start = torch.cumsum(true_n, 0) - true_n
        rank = torch.arange(row.shape[0], device=q.device) - start[row]
        keep = rank < max_hits
        want = torch.full((b, max_hits), -1, dtype=torch.int32,
                          device=q.device)
        want[row[keep], rank[keep]] = col[keep].to(torch.int32)
        ok = (torch.equal(want, hit_ids[i:i + b])
              and torch.equal(true_n, counts[i:i + b])
              and torch.equal(true_n > max_hits, overflow[i:i + b]))
        if not ok:
            raise AssertionError(f"range_ids disagree with brute force in "
                                 f"queries {i}..{i + b}")
        n_over += int((true_n > max_hits).sum())
    return n_over


def device_busy(torch, fn, reps: int):
    """Device time per call from torch.profiler (kernels, copies and
    sets on the card), and the five largest device consumers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / reps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return sum(by_name.values()), [[k[:80], v] for k, v in top]


def serve_phase(torch, dev):
    from repro_torch.core import geometry
    from repro_torch.data import spatial_gen
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.serve import ServeConfig, SpatialServer

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cbatches = [qboxes(torch, g, Q, 0.03, dev)
                for _ in range(BATCHES)]
    ibatches = [qboxes(torch, g, Q_IDS, 0.003, dev)
                for _ in range(ID_BATCHES)]

    kernel.reset_launches()
    hkernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mbrs = spatial_gen.osm_like(N, seed=SEED, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0

    servers, results = {}, {}
    for li in STAGINGS:
        t0 = time.perf_counter()
        srv = SpatialServer.from_method("bsp", mbrs, PAYLOAD,
                                        ServeConfig(local_index=li),
                                        device=dev)
        torch.cuda.synchronize()
        stage_s = time.perf_counter() - t0
        servers[li] = srv

        srv.range_counts(cbatches[0])               # warm-up (loads kernel)
        srv.range_ids(ibatches[0], max_hits=MAX_HITS)
        torch.cuda.synchronize()
        counts, c_ms, f_max, fan = [], [], 0, []
        for qb in cbatches:
            t0 = time.perf_counter()
            cnt, st = srv.range_counts(qb)
            torch.cuda.synchronize()
            c_ms.append((time.perf_counter() - t0) * 1e3)
            counts.append(cnt)
            f_max = max(f_max, st["f_max"])
            fan.append(st["fanout_mean"])
        ids, i_ms, i_fmax = [], [], 0
        for qb in ibatches:
            t0 = time.perf_counter()
            out = srv.range_ids(qb, max_hits=MAX_HITS)
            torch.cuda.synchronize()
            i_ms.append((time.perf_counter() - t0) * 1e3)
            ids.append(out[:3])
            i_fmax = max(i_fmax, out[3]["f_max"])
        dev_ms, top = device_busy(torch, lambda: srv.range_counts(
            cbatches[1 % len(cbatches)]), 3)
        dev_ids_ms, top_ids = device_busy(torch, lambda: srv.range_ids(
            ibatches[1 % len(ibatches)], max_hits=MAX_HITS), 3)
        results[li] = dict(counts=counts, ids=ids)
        emit(dict(
            phase="serve", local_index=li, n=N, payload=PAYLOAD,
            t=srv.stats["t"], cap=srv.stats["cap"],
            t_live=srv.stats["t_live"], chunks=srv.stats["chunks"],
            replication=srv.stats["replication"], stage_s=stage_s,
            gen_s=gen_s, resident_tile_bytes=srv.resident_tile_bytes(),
            counts=dict(q=Q, batches=len(c_ms),
                        qps=Q * len(c_ms) / (sum(c_ms) / 1e3),
                        p50_ms=pct(c_ms, 0.5), p99_ms=pct(c_ms, 0.99),
                        f_max=f_max,
                        fanout_mean=sum(fan) / len(fan),
                        device_ms_per_batch=dev_ms, top_device=top,
                        chunk_skip_rate=srv.chunk_skip_rate(cbatches[0])),
            ids=dict(q=Q_IDS, batches=len(i_ms),
                     qps=Q_IDS * len(i_ms) / (sum(i_ms) / 1e3),
                     p50_ms=pct(i_ms, 0.5), p99_ms=pct(i_ms, 0.99),
                     f_max=i_fmax, device_ms_per_batch=dev_ids_ms,
                     top_device=top_ids, select_sweep_in_top5=any(
                         "SelectSweep" in k for k, _ in top_ids)),
            max_memory_allocated=torch.cuda.max_memory_allocated()))
    launches = dict(kernel.LAUNCHES)
    encode_launches = hkernel.LAUNCHES["encode"]

    for li in ("off", "hilbert"):
        for a, b in zip(results["x"]["counts"], results[li]["counts"]):
            if not torch.equal(a, b):
                raise AssertionError(f'counts of local_index "x" and '
                                     f'"{li}" differ')
        for a, b in zip(results["x"]["ids"], results[li]["ids"]):
            if not all(torch.equal(u, v) for u, v in zip(a, b)):
                raise AssertionError(f'ids of local_index "x" and "{li}" '
                                     f'differ')
    check_counts(torch, geometry, mbrs, cbatches[0][:CHECK_Q],
                 results["x"]["counts"][0][:CHECK_Q])
    hit_ids, cnt, ovf = results["x"]["ids"][0]
    n_over = check_ids(torch, geometry, mbrs, ibatches[0], hit_ids, cnt, ovf,
                       MAX_HITS)
    emit(dict(phase="check", x_equals_off=True, x_equals_hilbert=True,
              encode_launches=encode_launches, brute_force_counts=CHECK_Q,
              brute_force_ids=Q_IDS, overflowed_queries=n_over,
              hits_in_first_counts_batch=int(results["x"]["counts"][0].sum())))
    for name in CASES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the serving "
                                 f"path: {launches}")
    for name in TABLES.values():
        if launches[name]:
            raise AssertionError(f"{name} built a hit table on the serving "
                                 f"path: {launches}")
    if encode_launches <= 0:
        raise AssertionError("encode was not launched by the hilbert "
                             "staging")
    # per server: warm-up + timed + profiled batches
    calls = dict(counts=1 + len(cbatches) + 3, ids=1 + len(ibatches) + 3)
    return (servers, mbrs, cbatches[0], ibatches[0], results["x"],
            launches, calls, encode_launches)


def pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def knn_brute(torch, knn_mod, mbrs, pts, k, block=8):
    """Exact kNN over all objects by the key ``bits(d2) << 32 | id``
    (d2 >= 0, so its bits order as its values) -> ``(ids, d2)``."""
    ar = torch.arange(mbrs.shape[0], device=mbrs.device)
    ids, d2s = [], []
    for i in range(0, pts.shape[0], block):
        d2 = knn_mod.mindist2_fused(pts[i:i + block], mbrs)
        key = (d2.view(torch.int32).long() << 32) | ar
        top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        ids.append((top & 0xFFFFFFFF).to(torch.int32))
        d2s.append((top >> 32).to(torch.int32).view(torch.float32))
    return torch.cat(ids), torch.cat(d2s)


def knn_phase(torch, servers, mbrs, dev):
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.query import knn as knn_mod

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    batches = [torch.rand(Q_KNN, 2, generator=g, device=dev)
               for _ in range(KNN_BATCHES)]
    kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    answers = {}
    for li in STAGINGS:
        srv = servers[li]
        ms, out = [], []
        for pts in batches:
            t0 = time.perf_counter()
            nn_ids, nn_d2, ovf, st = srv.knn(pts, K, max_cand=MAX_CAND)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(((nn_ids, nn_d2, ovf), st))
        dev_ms, top = device_busy(torch, lambda: srv.knn(
            batches[1], K, max_cand=MAX_CAND), 3)
        answers[li] = [a for a, _ in out]
        stats = [st for _, st in out]
        emit(dict(
            phase="knn", local_index=li, q=Q_KNN, k=K, max_cand=MAX_CAND,
            batches=len(ms), batch_ms=ms,
            qps=Q_KNN * len(ms) / (sum(ms) / 1e3), p50_ms=pct(ms, 0.5),
            p99_ms=pct(ms, 0.99), device_ms_per_batch=dev_ms,
            top_device=top, select_sweep_in_top5=any(
                "SelectSweep" in k for k, _ in top),
            f_max=[st["f_max"] for st in stats],
            retries=[st["retries"] for st in stats],
            max_rounds=max(st["rounds"] for st in stats),
            fanout_mean=sum(st["fanout_mean"] for st in stats) / len(stats),
            overflowed=sum(int(a[2].sum()) for a in answers[li]),
            max_memory_allocated=torch.cuda.max_memory_allocated()))
    launches = dict(kernel.LAUNCHES)

    for li in ("off", "hilbert"):
        for (xi, xd, xo), (oi, od, oo) in zip(answers["x"], answers[li]):
            if not (torch.equal(xo, oo) and torch.equal(xi[~xo], oi[~oo])
                    and torch.equal(xd[~xo], od[~oo])):
                raise AssertionError(f'kNN of local_index "x" and "{li}" '
                                     f'differ')
    nn_ids, nn_d2, ovf = answers["x"][0]
    want_ids, want_d2 = knn_brute(torch, knn_mod, mbrs,
                                  batches[0][:CHECK_KNN], K)
    ok = ~ovf[:CHECK_KNN]
    if not (torch.equal(nn_ids[:CHECK_KNN][ok], want_ids[ok])
            and torch.equal(nn_d2[:CHECK_KNN][ok], want_d2[ok])):
        raise AssertionError("kNN disagrees with the brute force")
    for name in CASES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the kNN "
                                 f"path: {launches}")
    for name in TABLES.values():
        if launches[name]:
            raise AssertionError(f"{name} built a hit table on the kNN "
                                 f"path: {launches}")
    emit(dict(phase="knn_check", x_equals_off_unflagged=True,
              x_equals_hilbert_unflagged=True,
              brute_force_points=CHECK_KNN,
              flagged_in_checked=int((~ok).sum()), launches=launches))
    return batches[0], answers["x"][0], launches


def dense_phase(torch, srv, mbrs, qc, qi, pts, pruned_x, pruned_knn):
    """The dense oracle on whole batches against the pruned answers of
    the same inputs and the on-card brute force -> the dense kernels'
    launches."""
    from repro_torch.core import geometry
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.query import knn as knn_mod

    kernel.reset_launches()
    calls = {}

    def timed(name, fn, reps=3):
        """``reps`` timed calls and one profiled -> the first answer."""
        before = dict(kernel.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ms, out = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            got = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out = got if out is None else out
        peak = torch.cuda.max_memory_allocated()
        dev_ms, top = device_busy(torch, fn, 1)
        calls[name] = dict(
            ms=ms, p50_ms=median(ms), device_ms=dev_ms, top_device=top,
            idle_share=1 - dev_ms / median(ms), peak_bytes=peak,
            peak_above_resident=peak - resident,
            launches_per_call={k: (v - before[k]) / (reps + 1)
                               for k, v in kernel.LAUNCHES.items()
                               if v != before[k]})
        return out

    counts, _ = timed("range_counts", lambda: srv.range_counts(
        qc, pruned=False))
    if not torch.equal(counts, pruned_x["counts"][0]):
        raise AssertionError("dense range_counts differ from pruned")
    check_counts(torch, geometry, mbrs, qc[:CHECK_Q], counts[:CHECK_Q])
    ids = timed("range_ids", lambda: srv.range_ids(
        qi, max_hits=MAX_HITS, pruned=False))
    if not all(torch.equal(u, v) for u, v in zip(ids[:3],
                                                 pruned_x["ids"][0])):
        raise AssertionError("dense range_ids differ from pruned")
    check_ids(torch, geometry, mbrs, qi, *ids[:3], MAX_HITS)
    timed("range_ids_256", lambda: srv.range_ids(
        qi[:DENSE_ROWS], max_hits=MAX_HITS, pruned=False))
    nn_ids, nn_d2, ovf, st = timed("knn", lambda: srv.knn(
        pts, K, max_cand=MAX_CAND, pruned=False))
    p_ids, p_d2, p_ovf = pruned_knn
    ok = ~(ovf | p_ovf)
    if not (torch.equal(nn_ids[ok], p_ids[ok])
            and torch.equal(nn_d2[ok], p_d2[ok])):
        raise AssertionError("dense kNN differs from pruned")
    want_ids, want_d2 = knn_brute(torch, knn_mod, mbrs, pts[:CHECK_KNN], K)
    mine = ~ovf[:CHECK_KNN]
    if not (torch.equal(nn_ids[:CHECK_KNN][mine], want_ids[mine])
            and torch.equal(nn_d2[:CHECK_KNN][mine], want_d2[mine])):
        raise AssertionError("dense kNN disagrees with the brute force")
    timed("knn_256", lambda: srv.knn(pts[:DENSE_ROWS], K, max_cand=MAX_CAND,
                                     pruned=False))
    launches = dict(kernel.LAUNCHES)
    for name in DENSE_OLD:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the dense "
                                 f"path: {launches}")
    for name in DENSE_OLD.values():
        if launches[name]:
            raise AssertionError(f"{name} was launched on the dense path: "
                                 f"{launches}")
    emit(dict(phase="dense", counts_q=qc.shape[0], ids_q=qi.shape[0],
              knn_q=pts.shape[0], calls=calls, knn_rounds=st["rounds"],
              knn_flagged=int((~ok).sum()), equal_to_pruned=True,
              brute_force_counts=CHECK_Q, brute_force_ids=qi.shape[0],
              brute_force_knn=int(mine.sum()), launches=launches))
    return launches


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def plain_blocked(torch, fn, q, cand, cap, mask_out, budget=2e9):
    """The plain version of one kernel over all queries, in blocks that
    bound its gathered (rows, F, cap, 4) intermediates.

    Queries go in descending order of live candidates, and a block
    gathers only its rows' live prefix of candidates: the router lists
    each query's candidates first and pads with -1, and the plain
    version gives a -1 candidate zero hits, so the padding columns are
    zeros without being gathered (checked below).
    """
    qn, f = cand.shape
    live = (cand >= 0).sum(1)
    order = torch.argsort(live, descending=True)
    live_sorted = live[order].tolist()
    shape = (qn, f, cap) if mask_out else (qn, f)
    out = torch.zeros(shape, dtype=torch.bool if mask_out else torch.int32,
                      device=q.device)
    i = 0
    while i < qn:
        fb = max(1, live_sorted[i])
        rows = max(1, int(budget // (fb * cap * 24)))
        idx = order[i:i + rows]
        if bool((cand[idx, fb:] >= 0).any()):
            raise AssertionError("candidates are not listed live-first")
        out[idx, :fb] = fn(q[idx], cand[idx, :fb])
        i += rows
    return out


def kernel_phase(torch, servers, qc, qi, pts, launches, calls):
    from repro_torch.kernels.range_probe import kernel, ops, ref
    from repro_torch.serve import router
    from repro_torch.serve.engine import _f_width

    lay = {li: s.layout for li, s in servers.items()}
    t, cap = lay["x"].canon_tiles.shape[:2]
    c = lay["x"].chunk_boxes.shape[1]
    gen = torch.Generator(device=qc.device).manual_seed(7)
    rand_alive = torch.rand(t, cap, generator=gen, device=qc.device) < 0.7
    bad = lay["x"].chunk_boxes.clone()   # do NOT bound their members
    jitter = torch.rand(bad.shape, generator=gen, device=qc.device) * 0.02
    bad = torch.cat([bad[..., :2] + jitter[..., :2],
                     bad[..., 2:] - jitter[..., 2:]], dim=-1).contiguous()

    def routed(srv, q):
        """The candidate lists the server routes for batch ``q``, at the
        width its ratchet gives (as ``_route_batch``, minus the update)."""
        hit = router.probe_overlap(srv.probe_boxes, q)
        floor = _f_width(int(hit.sum(1).max()), srv.stats["t_live"])
        f = srv.widths.at_least("range", floor)
        return router.candidates_from_overlap(hit, f)[0]

    entries = []
    for name, replaces in CASES.items():
        skip = name.endswith("_skip")
        li = "x" if skip else "off"
        tiles = lay[li].canon_tiles
        # (alive, the live extent the count and hit-list kernels may
        # stop at)
        extent = servers[li].tiles.extent
        alives = (("staged", (lay[li].alive, extent)), ("none", (None, None)),
                  ("random", (rand_alive, ops.live_extent(rand_alive))))
        boxes = ((("bounding", lay["x"].chunk_boxes), ("non_bounding", bad))
                 if skip else (("none", None),))
        cb0 = lay["x"].chunk_boxes if skip else None
        if name in TABLES:
            entries.append(hit_entry(
                torch, kernel, ops, ref, name, replaces, servers[li], tiles,
                qi.contiguous(), routed(servers[li], qi).contiguous(), pts,
                alives, boxes, cb0, launches, calls))
            continue
        q, cand = qc, routed(servers[li], qc)
        qn, f = cand.shape
        kfn = getattr(kernel, name)
        plain = getattr(ref, name.replace("gather_", "gathered_")
                        .replace("count", "counts"))

        def k_of(al_ext, cb):
            alive, ext = al_ext
            return kfn(q, tiles, *((cb,) if skip else ()), cand, alive=alive,
                       extent=ext)

        def plain_of(al_ext, cb):
            alive = al_ext[0]

            def r(qq, cc):
                boxes = ((ops.gathered_chunk_boxes(cb, cc),) if skip
                         else ())
                return plain(qq, ops.gathered_rows(tiles, cc), *boxes,
                             None if alive is None
                             else ops.gathered_alive(alive, cc))
            return plain_blocked(torch, r, q, cand, cap, False)

        cases, worst = timed_cases(torch, name, k_of, plain_of, alives,
                                   boxes)
        main = cases[0]      # the serving path's own inputs
        work = bound_work(torch, ref, ops, q, cand, tiles, lay[li].alive,
                          cb0, False, extent)
        entry = dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=launches[name], max_abs_err=worst, ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=work["bound_ms"],
            bound_by=work["bound_by"], library_ms=None, bit_equal=worst == 0,
            launches_per_batch=launches[name] / calls["counts"] / (
                len(INDEXED) if skip else 1),
            shape=dict(q=qn, f=f, t=t, cap=cap, c=c),
            bound_ms_per_pair=work["pair_bytes"] / HBM_BYTES_PER_S * 1e3,
            cases=cases)
        entry.update(count_designs(torch, kernel, k_of, tiles, cand, cb0,
                                   lay[li].alive, extent, main),
                     bound_ms_full_cap=work["bound_ms_full_cap"])
        entries.append(entry)
    return entries


def refinement_call(torch, srv, pts, skip):
    """The arguments of the last refinement of one kNN batch through
    ``srv`` (the ladder's final attempt) -> ``(qboxes, cand)``."""
    from repro_torch.kernels.range_probe import ops
    fn = "gathered_hit_list_skip" if skip else "gathered_hit_list"
    orig, seen = getattr(ops, fn), []

    def capture(qb, tiles, *rest, **kw):
        seen.append((qb, rest[-1]))
        return orig(qb, tiles, *rest, **kw)

    setattr(ops, fn, capture)
    try:
        srv.knn(pts, K, max_cand=MAX_CAND)
    finally:
        setattr(ops, fn, orig)
    qb, cand = seen[-1]
    return qb.float().contiguous(), cand.int().contiguous()


def hit_stages(torch, kernel, q, tiles, cand, cb, alive, extent):
    """CUDA-event ms of each stage of the hit list, on the path's own
    inputs, and the sizes that set them."""
    t, cap = tiles.shape[:2]
    kw = dict(cboxes=cb, alive=alive, extent=extent)

    def group():
        return kernel.group_pairs(cand, t, cap, extent, zero_counts=False)[1]

    scratch = group()
    seg = kernel.hit_counts(q, tiles, cand, scratch, **kw)
    incl = seg.view(-1).cumsum(0)
    return dict(
        group_ms=cuda_ms(torch, group, 10),
        count_ms=cuda_ms(torch, lambda: kernel.hit_counts(
            q, tiles, cand, scratch, **kw), 10),
        scan_ms=cuda_ms(torch, lambda: seg.view(-1).cumsum(0), 10),
        emit_ms=cuda_ms(torch, lambda: kernel.emit_hits(
            q, tiles, cand, scratch, seg, incl, **kw), 10),
        hits=int(incl[-1]), segments=seg.shape[2],
        count_cells_bytes=seg.numel() * 4,
        live_pairs=int((cand >= 0).sum()))


def old_extraction(torch, kernel, ops, q, tiles, cand, cb, alive):
    """The extraction before the hit lists, composed from the table
    kernel: ``gather_mask{,_skip}`` over ``hit_table_blocks``, then
    ``nonzero`` -> (3, H) int64."""
    parts = []
    for rows, w in ops.hit_table_blocks(cand, tiles.shape[1]):
        cd = cand[rows, :w].contiguous()
        extra = () if cb is None else (cb,)
        fn = kernel.gather_mask if cb is None else kernel.gather_mask_skip
        m = fn(q[rows].contiguous(), tiles, *extra, cd, alive=alive)
        bq, bf, bs = m.nonzero(as_tuple=True)
        parts.append(torch.stack([bq + rows.start, cd[bq, bf].long(), bs]))
    return torch.cat(parts, 1) if parts else torch.zeros(
        (3, 0), dtype=torch.int64, device=q.device)


def hit_entry(torch, kernel, ops, ref, name, replaces, srv, tiles, q, cand,
              pts, alives, boxes, cb0, launches, calls):
    """One routed hit list's row: the emit pipeline held to its plain
    version on the ids batch whole and on one kNN refinement call, in
    every alive and chunk-box case; its stages; the old extraction on
    the same inputs; and the table kernel of the same TPU kernel held
    to its plain version on the old executor's largest table block."""
    skip = cb0 is not None
    cap = tiles.shape[1]
    alive, extent = alives[0][1]
    kfn = getattr(kernel, name)

    def pipeline(qq, cc):
        def k_of(al_ext, cb):
            return kfn(qq, tiles, *((cb,) if skip else ()), cc,
                       alive=al_ext[0], extent=al_ext[1])

        def plain_of(al_ext, cb):
            return torch.stack(ops.plain_hit_list(
                qq, tiles, cc, cb, alive=al_ext[0], budget=PLAIN_TABLE))

        cases, worst = timed_cases(torch, name, k_of, plain_of, alives,
                                   boxes)
        main = k_of(alives[0][1], cb0)
        old = old_extraction(torch, kernel, ops, qq, tiles, cc, cb0, alive)
        if not torch.equal(old, main):
            raise AssertionError(f"{name}: the old extraction gives another "
                                 f"list")
        stages = hit_stages(torch, kernel, qq, tiles, cc, cb0, alive, extent)
        work = bound_work(torch, ref, ops, qq, cc, tiles, alive, cb0, False,
                          extent, out_bytes=stages["hits"] * HIT_BYTES)
        return dict(
            ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
            max_abs_err=worst, bound_ms=work["bound_ms"],
            bound_by=work["bound_by"],
            old_extraction_ms=cuda_ms(torch, lambda: old_extraction(
                torch, kernel, ops, qq, tiles, cc, cb0, alive), 3),
            stages=stages, shape=dict(q=cc.shape[0], f=cc.shape[1],
                                      t=tiles.shape[0], cap=cap),
            cases=cases)

    ids = pipeline(q, cand)
    knn = pipeline(*refinement_call(torch, srv, pts, skip))

    # the table kernel, as before, on the old ids executor's largest block
    table = TABLES[name]
    rows, w = max(ops.hit_table_blocks(cand, cap),
                  key=lambda b: (b[0].stop - b[0].start) * b[1])
    tq, tc = q[rows].contiguous(), cand[rows, :w].contiguous()
    tfn = getattr(kernel, table)
    plain = getattr(ref, table.replace("gather_", "gathered_"))

    def t_of(al_ext, cb):
        return tfn(tq, tiles, *((cb,) if skip else ()), tc, alive=al_ext[0])

    def tplain_of(al_ext, cb):
        al = al_ext[0]

        def r(qq, cc):
            extra = (ops.gathered_chunk_boxes(cb, cc),) if skip else ()
            return plain(qq, ops.gathered_rows(tiles, cc), *extra,
                         None if al is None else ops.gathered_alive(al, cc))
        return plain_blocked(torch, r, tq, tc, cap, True)

    tcases, tworst = timed_cases(torch, table, t_of, tplain_of, alives, boxes)
    twork = bound_work(torch, ref, ops, tq, tc, tiles, alive, cb0, True)
    return dict(
        name=name, route="cuda", source=SOURCE, replaces=replaces,
        launches=launches[name], max_abs_err=max(ids["max_abs_err"],
                                                 knn["max_abs_err"], tworst),
        ms=ids["ms"], plain_ms=ids["plain_ms"], bound_ms=ids["bound_ms"],
        bound_by=ids["bound_by"], library_ms=None,
        bit_equal=max(ids["max_abs_err"], knn["max_abs_err"], tworst) == 0,
        design="count, scan, emit", table_kernel=table,
        table_ms=tcases[0]["ms"], table_plain_ms=tcases[0]["plain_ms"],
        table_bound_ms=twork["bound_ms"], table_launches=launches[table],
        table_shape=dict(q=tq.shape[0], f=w, cap=cap),
        table_cases=tcases, old_extraction_ms=ids["old_extraction_ms"],
        launches_per_batch=launches[name] / calls["ids"] / (
            len(INDEXED) if skip else 1),
        ids=ids, knn_refinement=knn)


def count_designs(torch, kernel, k_of, tiles, cand, cb, alive, extent,
                  main):
    """The routed count kernel on the serving path's inputs without the
    live extent (bit-equal, else raise), the grouping pass alone, and
    the batch's shape (live pairs, -1 share, extents)."""
    t, cap = tiles.shape[:2]
    full = lambda: k_of((alive, None), cb)  # noqa: E731
    if not torch.equal(full(), k_of((alive, extent), cb)):
        raise AssertionError("the count kernel differs without the extent")
    group_ms = cuda_ms(torch, lambda: kernel.group_pairs(cand, t, cap,
                                                         extent), 10)
    live = int((cand >= 0).sum())
    return dict(full_cap_ms=cuda_ms(torch, full, 10), group_ms=group_ms,
                group_share=group_ms / main["ms"], live_pairs=live,
                f=cand.shape[1], pad_share=1 - live / max(cand.numel(), 1),
                extent_mean=float(extent.float().mean()),
                extent_max=int(extent.max()))


def bound_work(torch, ref, ops, q, cand, tiles, alive, cboxes, mask_out,
               extent=None, rows=64, out_bytes=None):
    """Least bytes and operations of one call on these inputs.

    bytes: every (tile, chunk) that some live (query, candidate) pair
    must examine, read once (its alive flags, and its member boxes where
    alive), the chunk boxes of every referenced tile, the queries, the
    candidate list and the output.  With the live ``extent`` an input,
    no slot past it is alive, so the least work stops there: a tile's
    chunks, alive flags and chunk boxes count only up to its extent
    (``bound_ms``); ``bound_ms_full_cap`` counts them over all of cap,
    as before the extent existed.  The output is the (Q, F) counts,
    the (Q, F, cap) table (``mask_out``) or, given ``out_bytes``, a hit
    list's.  Also returned: the reads counted per pair,
    Q*F*live_chunks*128*(16 + 1) plus the output, the bound of a design
    that shares no tile between queries.  operations: four float
    compares per alive slot of every live pair's live chunks.
    """
    t, cap = tiles.shape[:2]
    chunk = ops.CHUNK
    n_chunks = -(-cap // chunk)
    dev = q.device
    c0 = torch.arange(n_chunks, device=dev) * chunk
    if extent is None:
        lim = torch.full((t,), cap, dtype=torch.int64, device=dev)
    else:
        lim = extent.long()
    # slots of each (tile, chunk) below the tile's limit
    below = (lim[:, None] - c0[None, :]).clamp(0, chunk)
    below = torch.cat([below, below.new_zeros(1, n_chunks)])   # -1 row
    touched = torch.zeros(t + 1, n_chunks, dtype=torch.bool, device=dev)
    touched_full = torch.zeros_like(touched)
    pair_chunks = pair_chunks_full = 0
    for i in range(0, q.shape[0], rows):
        cc = cand[i:i + rows]
        idx = torch.where(cc >= 0, cc, t).long()
        if cboxes is None:
            live = (cc >= 0)[..., None].expand(-1, -1, n_chunks)
        else:
            live = ref.gathered_chunk_hits(
                q[i:i + rows], ops.gathered_chunk_boxes(cboxes, cc))
            live = live & (cc >= 0)[..., None]
        live_e = live & (below[idx] > 0)
        for lv, tch in ((live, touched_full), (live_e, touched)):
            tt = idx[..., None].expand_as(lv)[lv]
            tch[tt, torch.nonzero(lv, as_tuple=True)[2]] = True
        pair_chunks_full += int(live.sum())
        pair_chunks += int(live_e.sum())
    touched, touched_full = touched[:t], touched_full[:t]
    slot_alive = torch.cat([alive, alive.new_zeros(
        t, n_chunks * chunk - cap)], dim=1)
    alive_per_chunk = slot_alive.reshape(t, n_chunks, chunk).sum(2)
    alive_touched = int(alive_per_chunk[touched_full].sum())
    ref_t = torch.unique(cand[cand >= 0]).long()
    if out_bytes is None:
        out_bytes = cand.numel() * (cap if mask_out else 4)
    fixed = q.numel() * 4 + cand.numel() * 4 + out_bytes + alive_touched * 16
    box_chunks = (int((-(-lim[ref_t] // chunk)).sum()) if cboxes is not None
                  else 0)
    bytes_ = (int(below[:t][touched].sum()) + box_chunks * 16 + fixed)
    bytes_full = (int(touched_full.sum()) * chunk + fixed
                  + (ref_t.numel() * n_chunks * 16 if cboxes is not None
                     else 0))
    ops_ = 4 * pair_chunks * alive_touched / max(int(touched.sum()), 1)
    ops_full = (4 * pair_chunks_full * alive_touched
                / max(int(touched_full.sum()), 1))

    def bound(b, o):
        return max(b / HBM_BYTES_PER_S, o / FP32_OPS_PER_S) * 1e3

    return dict(
        bytes=bytes_, ops=ops_, bound_ms=bound(bytes_, ops_),
        bound_by=("bytes" if bytes_ / HBM_BYTES_PER_S >= ops_ / FP32_OPS_PER_S
                  else "operations"),
        bound_ms_full_cap=bound(bytes_full, ops_full),
        pair_bytes=pair_chunks * chunk * 17 + out_bytes)


def timed_cases(torch, name, k_of, plain_of, alives, boxes):
    """Run one kernel and its plain version on every (alive, chunk box)
    case; raise unless bit-equal -> ``(cases, worst error)``."""
    cases, worst = [], 0
    for alive_name, alive in alives:
        for cb_name, cb in boxes:
            def k():
                return k_of(alive, cb)
            got = k()
            t_plain = time.perf_counter()
            want = plain_of(alive, cb)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t_plain) * 1e3
            if got.shape != want.shape:
                raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                                     f"{tuple(want.shape)}")
            err = 0 if not got.numel() else int(
                torch.ne(got, want).any() if got.dtype == torch.bool
                else (got - want).abs().max())
            if err != 0:
                raise AssertionError(
                    f"{name} (alive={alive_name}, chunk boxes={cb_name}) "
                    f"differs from its plain version: max abs err {err}")
            worst = max(worst, err)
            cases.append(dict(alive=alive_name, chunk_boxes=cb_name,
                              ms=cuda_ms(torch, k, 10), plain_ms=plain_ms))
    return cases, worst


def dense_kernel_phase(torch, srv, qc, qi, pts, launches):
    """The dense kernels on the "x" staging: the tile-major counts at the
    dense counts batch (Q = 4096), the dense hit list on the ids batch
    and the dense kNN's refinement, and the chunk-skipping pair (counts
    at Q = 4096, the table at the old dense executor's hit-table block
    of the ids batch), each in both its designs."""
    from repro_torch.kernels.range_probe import kernel, ops, ref

    lay = srv.layout
    tiles, alive, cbs = lay.canon_tiles, lay.alive, lay.chunk_boxes
    t, cap = tiles.shape[:2]
    gen = torch.Generator(device=qc.device).manual_seed(8)
    rand_alive = torch.rand(t, cap, generator=gen, device=qc.device) < 0.7
    jitter = torch.rand(cbs.shape, generator=gen, device=qc.device) * 0.02
    bad = torch.cat([cbs[..., :2] + jitter[..., :2],
                     cbs[..., 2:] - jitter[..., 2:]], dim=-1).contiguous()
    alives = (("staged", (alive, srv.tiles.extent)), ("none", (None, None)),
              ("random", (rand_alive, ops.live_extent(rand_alive))))
    entries = [
        dense_count_entry(torch, kernel, ref, qc, tiles, alives, launches),
        dense_hits_entry(torch, kernel, ops, ref, srv, qi, pts, tiles,
                         alives, launches)]
    rows = ops.dense_blocks(qi.shape[0], t * cap)[0]
    for name in ("count_skip", "mask_skip"):
        entries.append(dense_skip_entry(
            torch, kernel, ref, name, qi[rows] if name == "mask_skip" else qc,
            tiles, alive, cbs, bad, alives, launches))
    for e in entries:    # a time below the bound would be a wrong bound
        if e["ms"] < e["bound_ms"]:
            raise AssertionError(f"{e['name']}: {e['ms']} ms is below its "
                                 f"stated bound, {e['bound_ms']} ms")
    return entries


def dense_skip_entry(torch, kernel, ref, name, q, tiles, alive, cbs, bad,
                     alives, launches):
    """Rows 7 and 8, the dense chunk-skipping pair (no serving caller):
    in all six (alive, chunk box) cases the new design (to each case's
    extent, and without it) and the first design (``_v1``) held to the
    plain version, bit-equal else raise; the two designs timed in turns
    (new, first, first, new), and for the counts the tile-major dense
    counts on the same inputs in the same turns."""
    mask_out = name == "mask_skip"
    kfn, v1fn = getattr(kernel, name), getattr(kernel, name + "_v1")
    plain = getattr(ref, "probe_" + name.replace("count", "counts"))
    t, cap = tiles.shape[:2]

    def plain_of(al, cb, block=8):
        if mask_out:
            return plain(q, tiles, cb, al).transpose(0, 1)
        return torch.cat([plain(q[i:i + block], tiles, cb, al)
                          for i in range(0, q.shape[0], block)])

    cases = []
    for alive_name, (al, ext) in alives:
        for cb_name, cb in (("bounding", cbs), ("non_bounding", bad)):
            designs = dict(
                new=lambda al=al, ext=ext, cb=cb: kfn(q, tiles, cb, alive=al,
                                                      extent=ext),
                full_cap=lambda al=al, cb=cb: kfn(q, tiles, cb, alive=al),
                v1=lambda al=al, cb=cb: v1fn(q, tiles, cb, alive=al))
            got = {k: fn() for k, fn in designs.items()}
            t0 = time.perf_counter()
            want = plain_of(al, cb)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            for k, out in got.items():
                if out.shape != want.shape or not torch.equal(out, want):
                    raise AssertionError(
                        f"{name} ({k}, alive={alive_name}, chunk boxes="
                        f"{cb_name}) differs from its plain version")
            turns = [("new", designs["new"]), ("v1", designs["v1"])]
            if not mask_out and cb_name == "bounding":
                def dense(al=al, ext=ext):
                    return kernel.dense_counts(q, tiles, alive=al, extent=ext)
                # chunk boxes that bound their members skip no hit
                if not torch.equal(dense(), want):
                    raise AssertionError("dense counts differ from the "
                                         "skipping plain version on bounding "
                                         "chunk boxes")
                turns.append(("dense_counts", dense))
            ms = {k: [] for k, _ in turns}
            for k, fn in turns + turns[::-1]:
                ms[k].append(cuda_ms(torch, fn, 10))
            case = dict(alive=alive_name, chunk_boxes=cb_name,
                        plain_ms=plain_ms,
                        full_cap_ms=cuda_ms(torch, designs["full_cap"], 10),
                        **{("ms" if k == "new" else f"{k}_ms"): sum(v) / 2
                           for k, v in ms.items()},
                        turns_ms=ms)
            cases.append(case)
    main = cases[0]      # staged alive mask, bounding chunk boxes
    al0, ext0 = alives[0][1]
    work = dense_bound_work(torch, ref, q, tiles, al0, cbs, mask_out, ext0)
    entry = dict(
        name=name, route="cuda", source=SOURCE,
        replaces=DENSE_CASES[name], launches=launches[name],
        max_abs_err=0, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=work["bound_ms"], bound_by=work["bound_by"],
        library_ms=None, bit_equal=True, on_serving_path=False,
        launched_by="this phase only (repro launches it from tests only)",
        design=("tile-major to the extent, Morton-ordered runs, live "
                "(unit, run) items" if not mask_out else
                "slot-parallel, 16 slots a thread, 16-byte stores"),
        old_design=name + "_v1", old_design_ms=main["v1_ms"],
        old_launches=launches[name + "_v1"],
        bound_ms_full_cap=work["bound_ms_full_cap"],
        bound_bytes=work["bytes"], bound_ops=work["ops"],
        bound_share=work["bound_ms"] / main["ms"],
        shape=dict(q=q.shape[0], t=t, cap=cap, c=cbs.shape[1]),
        cases=cases)
    if not mask_out:
        entry["dense_counts_ms"] = main["dense_counts_ms"]
    return entry


def plain_dense_counts(torch, ref, q, tiles, alive, block=8):
    return torch.cat([ref.probe_counts(q[i:i + block], tiles, alive)
                      for i in range(0, q.shape[0], block)])


def dense_count_entry(torch, kernel, ref, q, tiles, alives, launches):
    """Row 5: the tile-major dense counts (four queries a thread, to each
    tile's extent) on the dense counts batch, in every alive case, held
    to the plain version; beside them on the same inputs, each held to
    it too: the same kernel without the extent and the old
    block-per-(tile, query block) ``count``."""
    t, cap = tiles.shape[:2]
    cases = []
    for alive_name, (al, ext) in alives:
        t0 = time.perf_counter()
        want = plain_dense_counts(torch, ref, q, tiles, al)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3

        def new(e=ext, al=al):
            return kernel.dense_counts(q, tiles, alive=al, extent=e)

        def old(al=al):
            return kernel.count(q, tiles, alive=al)

        case = dict(alive=alive_name, plain_ms=plain_ms)
        for key, fn, reps in (("ms", new, 10),
                              ("full_cap_ms", lambda: new(None), 10),
                              ("old_design_ms", old, 3)):
            if not torch.equal(fn(), want):
                raise AssertionError(f"dense counts ({key}, alive="
                                     f"{alive_name}) differ from the plain "
                                     f"version")
            case[key] = cuda_ms(torch, fn, reps)
        cases.append(case)
    main = cases[0]
    al, ext = alives[0][1]
    work = dense_bound_work(torch, ref, q, tiles, al, None, False, ext)
    return dict(
        name="dense_counts", route="cuda", source=SOURCE,
        replaces=DENSE_CASES["dense_counts"],
        launches=launches["dense_counts"], max_abs_err=0, ms=main["ms"],
        plain_ms=main["plain_ms"], bound_ms=work["bound_ms"],
        bound_by=work["bound_by"], library_ms=None, bit_equal=True,
        design="tile-major, four queries a thread, to the extent",
        old_design="count", old_design_ms=main["old_design_ms"],
        old_launches=launches["count"],
        bound_ms_full_cap=work["bound_ms_full_cap"],
        group_ms=cuda_ms(torch, lambda: kernel.dense_group(tiles, ext), 10),
        extent_sum=int(ext.long().sum()), alive_slots=int(al.sum()),
        shape=dict(q=q.shape[0], t=t, cap=cap), cases=cases)


def dense_refinement(torch, srv, pts):
    """The query boxes of the dense kNN's refinement of ``pts``."""
    from repro_torch.kernels.range_probe import ops
    orig, seen = ops.dense_hit_list, []

    def capture(qb, *args, **kw):
        seen.append(qb)
        return orig(qb, *args, **kw)

    ops.dense_hit_list = capture
    try:
        srv.knn(pts, K, max_cand=MAX_CAND, pruned=False)
    finally:
        ops.dense_hit_list = orig
    return seen[-1].float().contiguous()


def old_dense_extraction(torch, kernel, ops, q, tiles, alive):
    """The dense extraction before the hit list: ``mask``'s table over
    ``dense_blocks`` (2 GiB each), then ``nonzero`` -> (3, H) int64."""
    t, cap = tiles.shape[:2]
    parts = []
    for rows in ops.dense_blocks(q.shape[0], t * cap):
        m = kernel.mask(q[rows].contiguous(), tiles, alive=alive)
        bq, bt, bs = m.nonzero(as_tuple=True)
        parts.append(torch.stack([bq + rows.start, bt, bs]))
    return torch.cat(parts, 1)


def dense_hit_stages(torch, kernel, q, tiles, alive, extent):
    """CUDA-event ms of each stage of the dense hit list (one block), on
    the path's own inputs, and the sizes that set them."""
    t = tiles.shape[0]
    kw = dict(alive=alive, extent=extent)
    scratch = kernel.dense_group(tiles, extent)
    seg = kernel.dense_hit_counts(q, tiles, scratch, **kw)
    incl = seg.view(-1).cumsum(0)

    return dict(
        group_ms=cuda_ms(torch, lambda: kernel.dense_group(tiles, extent),
                         10),
        count_ms=cuda_ms(torch, lambda: kernel.dense_hit_counts(
            q, tiles, scratch, **kw), 10),
        scan_ms=cuda_ms(torch, lambda: seg.view(-1).cumsum(0), 10),
        emit_ms=cuda_ms(torch, lambda: kernel.dense_emit_hits(
            q, tiles, scratch, seg, incl, **kw), 10),
        hits=int(incl[-1]), segments=seg.shape[2],
        units=int(scratch[3 * t]), count_cells_bytes=seg.numel() * 4)


def dense_hits_entry(torch, kernel, ops, ref, srv, qi, pts, tiles, alives,
                     launches):
    """Row 6: the dense hit list (count, scan, emit to each tile's
    extent) held to its plain version (the reference's table in blocks,
    then ``nonzero``) on the ids batch whole and on the dense kNN's
    refinement, in every alive case; its stages; the old extraction on
    the same inputs; and the old table kernel ``mask`` held to its
    plain version on the old executor's table block."""
    t, cap = tiles.shape[:2]
    al0, ext0 = alives[0][1]

    def pipeline(qq):
        cases = []
        for alive_name, (al, ext) in alives:
            def fn(al=al, ext=ext):
                return torch.stack(ops.dense_hit_list(qq, tiles, alive=al,
                                                      extent=ext))
            got = fn()
            t0 = time.perf_counter()
            want = torch.stack(ops.plain_dense_hit_list(qq, tiles, alive=al))
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            if not torch.equal(got, want):
                raise AssertionError(f"dense_hits (alive={alive_name}) "
                                     f"differs from its plain version")
            full = torch.stack(ops.dense_hit_list(qq, tiles, alive=al))
            if not torch.equal(full, want):
                raise AssertionError("dense_hits differs without the extent")
            cases.append(dict(alive=alive_name, ms=cuda_ms(torch, fn, 10),
                              plain_ms=plain_ms, hits=got.shape[1]))
        main = torch.stack(ops.dense_hit_list(qq, tiles, alive=al0,
                                              extent=ext0))
        old = old_dense_extraction(torch, kernel, ops, qq, tiles, al0)
        if not torch.equal(old, main):
            raise AssertionError("dense_hits: the old extraction gives "
                                 "another list")
        stages = dense_hit_stages(torch, kernel, qq, tiles, al0, ext0)
        work = dense_bound_work(torch, ref, qq, tiles, al0, None, False, ext0,
                                out_bytes=stages["hits"] * HIT_BYTES)
        return dict(
            ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
            bound_ms=work["bound_ms"], bound_by=work["bound_by"],
            bound_ms_full_cap=work["bound_ms_full_cap"],
            old_extraction_ms=cuda_ms(torch, lambda: old_dense_extraction(
                torch, kernel, ops, qq, tiles, al0), 3),
            stages=stages, q=qq.shape[0], cases=cases)

    ids = pipeline(qi)
    ids_256 = pipeline(qi[:DENSE_ROWS].contiguous())
    knn = pipeline(dense_refinement(torch, srv, pts))

    # the old table kernel, on the old dense executor's first table block
    rows = ops.dense_blocks(qi.shape[0], t * cap)[0]
    tq = qi[rows].contiguous()

    def t_of(al, cb):
        return kernel.mask(tq, tiles, alive=al[0])

    def tplain_of(al, cb):
        return ref.probe_mask(tq, tiles, al[0]).transpose(0, 1)

    tcases, tworst = timed_cases(torch, "mask", t_of, tplain_of, alives,
                                 (("none", None),))
    twork = dense_bound_work(torch, ref, tq, tiles, al0, None, True)
    return dict(
        name="dense_hits", route="cuda", source=SOURCE,
        replaces=DENSE_CASES["dense_hits"], launches=launches["dense_hits"],
        max_abs_err=tworst, ms=ids["ms"], plain_ms=ids["plain_ms"],
        bound_ms=ids["bound_ms"], bound_by=ids["bound_by"], library_ms=None,
        bit_equal=tworst == 0, design="count, scan, emit, to the extent",
        bound_ms_full_cap=ids["bound_ms_full_cap"],
        old_design="mask + nonzero", old_design_ms=ids["old_extraction_ms"],
        old_extraction_ms=ids["old_extraction_ms"], table_kernel="mask",
        table_ms=tcases[0]["ms"], table_plain_ms=tcases[0]["plain_ms"],
        table_bound_ms=twork["bound_ms"], table_launches=launches["mask"],
        table_shape=dict(q=tq.shape[0], t=t, cap=cap), table_cases=tcases,
        ids=ids, ids_256=ids_256, knn_refinement=knn)


def dense_bound_work(torch, ref, q, tiles, alive, cboxes, mask_out,
                     extent=None, out_bytes=None, rows=16):
    """Least bytes and operations of one dense call on these inputs.

    bytes: the queries and the output written once ((Q, T) counts, the
    (Q, T, cap) table (``mask_out``) or, given ``out_bytes``, a hit
    list's), and each input read once: without chunk boxes every alive
    flag and every alive slot's box; with them, the alive flags of the
    chunks some query reaches, the boxes of their alive slots, and the
    chunk boxes.  Given the ``extent`` (no slot past it is alive), flags
    and chunk boxes count up to each tile's extent (``bound_ms``), else
    over all of cap (``bound_ms_full_cap``, also computed with it).
    operations: four float compares per (query, alive slot) and, with
    chunk boxes, per (query, alive slot) of the chunks the query hits
    plus per (query, chunk) test of the chunks that hold an alive slot
    (all below the extent; a chunk with none adds nothing to any count,
    tested or not).
    """
    t, cap = tiles.shape[:2]
    qn = q.shape[0]
    n_alive = int(alive.sum())
    if out_bytes is None:
        out_bytes = qn * t * (cap if mask_out else 4)
    base = q.numel() * 4 + out_bytes
    lim = (torch.full((t,), cap, dtype=torch.int64, device=q.device)
           if extent is None else extent.long())
    if cboxes is None:
        ops_ = ops_full = 4 * qn * n_alive
        bytes_ = base + n_alive * 16 + int(lim.sum())
        bytes_full = base + n_alive * 16 + t * cap
    else:
        n_chunks = cboxes.shape[1]
        c0 = torch.arange(n_chunks, device=q.device) * 128
        below = (lim[:, None] - c0[None, :]).clamp(0, 128)  # flags to read
        in_cap = (cap - c0).clamp(max=128).expand(t, -1)
        slot_alive = torch.cat([alive, alive.new_zeros(
            t, n_chunks * 128 - cap)], dim=1)
        per_chunk = slot_alive.reshape(t, n_chunks, 128).sum(2)
        reached = torch.zeros(t, n_chunks, dtype=torch.bool, device=q.device)
        live_slots = 0
        for i in range(0, qn, rows):
            hit = ref.chunk_hits(q[i:i + rows], cboxes)       # (B, T, C)
            reached |= hit.any(0)
            live_slots += int((hit * per_chunk).sum())
        boxes = int(per_chunk[reached].sum()) * 16
        chunks_below = int((-(-lim // 128)).sum())
        bytes_ = base + boxes + int(below[reached].sum()) + chunks_below * 16
        bytes_full = (base + boxes + int(in_cap[reached].sum())
                      + t * n_chunks * 16)
        ops_ = ops_full = 4 * live_slots + 4 * qn * int((per_chunk > 0).sum())

    def bound(b, o):
        return max(b / HBM_BYTES_PER_S, o / FP32_OPS_PER_S) * 1e3

    return dict(
        bytes=bytes_, ops=ops_, bound_ms=bound(bytes_, ops_),
        bound_by=("bytes" if bytes_ / HBM_BYTES_PER_S >= ops_ / FP32_OPS_PER_S
                  else "operations"),
        bound_ms_full_cap=bound(bytes_full, ops_full))


def median(xs):
    return sorted(xs)[len(xs) // 2]


def timed_s(torch, fn):
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def join_inputs(torch, dev):
    """R and S of each join input, generated on the card (seeds 0, 1)."""
    from repro_torch.data import spatial_gen
    return {name: (spatial_gen.dataset(name, n, seed=SEED, device=dev),
                   spatial_gen.dataset(name, n, seed=SEED + 1, device=dev))
            for name, n in JOIN_INPUTS.items()}


def partition_phase(torch, r, s):
    """The six partitioners on the merged pi input, with the paper's
    layout metrics -> hc's encode launches."""
    from repro_torch.core import metrics
    from repro_torch.core.partition import api, partition_counts
    from repro_torch.kernels.hilbert import kernel as hkernel

    merged = torch.cat([r, s])
    n = merged.shape[0]
    hkernel.reset_launches()
    for method in METHODS:
        before = hkernel.LAUNCHES["encode"]
        parts, secs = timed_s(torch, lambda: api.partition(method, merged,
                                                           PAYLOAD))
        counts, copies = partition_counts(merged, parts)
        emit(dict(
            phase="partition", method=method, n=n, payload=PAYLOAD,
            seconds=secs, k=parts.k(), kmax=parts.kmax,
            lambda_=float(metrics.boundary_ratio(counts, parts.valid, n)),
            balance_stddev=float(metrics.balance_stddev(counts,
                                                        parts.valid)),
            skew=float(metrics.skew_ratio(counts, parts.valid)),
            coverage=float(metrics.coverage(copies)),
            encode_launches=hkernel.LAUNCHES["encode"] - before))
    launches = hkernel.LAUNCHES["encode"]
    if launches <= 0:
        raise AssertionError("hc did not launch the encode kernel")
    return launches


def live_tiles(plan):
    """(slot, live_r, live_s) of a one-device plan's tiles with members
    on both sides."""
    for j, (nr, ns) in enumerate(zip(plan.live_r[0], plan.live_s[0])):
        if nr and ns:
            yield j, int(nr), int(ns)


def old_raw_counts(torch, plan):
    """The per-tile raw count the batched one replaced, a yardstick: tile
    by tile, ``join.tile_join_count(dedup="none")`` (``pad_cm`` and the
    ``count`` kernel's block sums) -> (T,) int64."""
    from repro_torch.query import join

    out = torch.zeros(plan.r_tiles.shape[1], dtype=torch.int64,
                      device=plan.r_tiles.device)
    for j, nr, ns in live_tiles(plan):
        out[j] = join.tile_join_count(plan.r_tiles[0, j, :nr],
                                      plan.s_tiles[0, j, :ns],
                                      plan.tile_boxes[0, j], plan.universe,
                                      dedup="none")
    return out


def old_join(torch, plan, overlapping, max_pairs):
    """The per-tile table join on the same plan, a yardstick: tile by tile, the
    ``mask`` table kernel, then ``rp_own_mask``, ``&`` and a sum (rp), or
    ``nonzero`` (MASJ) and ``unique_pairs`` over the concatenation ->
    ``(count, per-tile counts or (rid, sid))``."""
    from repro_torch.query import dedup, join

    tiles = list(live_tiles(plan))

    def args(j, nr, ns):
        return (plan.r_tiles[0, j, :nr], plan.s_tiles[0, j, :ns])

    if not overlapping:
        out = torch.zeros(plan.r_tiles.shape[1], dtype=torch.int64,
                          device=plan.r_tiles.device)
        for j, nr, ns in tiles:
            out[j] = join.tile_join_count(*args(j, nr, ns),
                                          plan.tile_boxes[0, j],
                                          plan.universe)
        return int(out.sum()), out
    prs, pss = [], []
    for j, nr, ns in tiles:
        pr, ps, _ = join.tile_pairs(*args(j, nr, ns), plan.r_ids[0, j, :nr],
                                    plan.s_ids[0, j, :ns],
                                    plan.tile_boxes[0, j], plan.universe,
                                    max_pairs)
        prs.append(pr)
        pss.append(ps)
    rid, sid = torch.cat(prs), torch.cat(pss)
    return int(dedup.unique_pairs(rid, sid)[0]), (rid, sid)


def join_phase(torch, dev, inputs):
    """plan_join + spatial_join_count for six layouts on each input ->
    ``(results, launches, bsp plans' largest tiles, bsp pair lists, the
    bsp and hc plans)``.  The per-tile table join runs on the bsp and hc
    plans as a yardstick; its launches are not counted."""
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.query import engine

    hkernel.reset_launches()
    mkernel.reset_launches()
    results, tiles, pairs, plans = {}, {}, {}, {}
    for name, (r, s) in inputs.items():
        for method in METHODS:
            torch.cuda.reset_peak_memory_stats()
            plan_s = []
            for _ in range(3):
                plan, secs = timed_s(torch, lambda: engine.plan_join(
                    method, r, s, PAYLOAD, 1, device=dev))
                plan_s.append(secs)
            m0 = dict(mkernel.LAUNCHES)
            per_tile = engine.tile_counts(plan, dedup="none")
            raw = int(per_tile.sum())
            max_n = max(int(per_tile.max()), 1)
            m1 = dict(mkernel.LAUNCHES)
            raw_launches = {k: m1[k] - m0[k] for k in m1}
            if raw_launches["raw_counts"] != 1 or raw_launches["count"]:
                raise AssertionError(f"{name} {method}: the raw count "
                                     f"launched {raw_launches}, want one "
                                     f"raw_counts and no count")
            raw_s = []
            for _ in range(3):
                _, secs = timed_s(torch, lambda: engine.run_join_count(
                    plan, dedup="none"))
                raw_s.append(secs)
            m1 = dict(mkernel.LAUNCHES)
            old_raw = old_raw_counts(torch, plan)
            mkernel.LAUNCHES.update(m1)              # the yardstick's
            if not torch.equal(old_raw, per_tile):
                raise AssertionError(f"{name} {method}: the per-tile raw "
                                     f"count differs from the batched one")
            join_s = []
            for _ in range(3):
                exact, secs = timed_s(torch, lambda: engine.spatial_join_count(
                    plan, max_pairs_per_tile=max_n))
                join_s.append(secs)
            m2 = dict(mkernel.LAUNCHES)
            per_join = {k: (m2[k] - m1[k]) / 3 for k in m2}
            st = plan.stats
            want = ({"pair_list": 1, "rp_counts": 0} if st["overlapping"]
                    else {"pair_list": 0, "rp_counts": 1})
            if any(per_join[k] != v for k, v in dict(want, mask=0,
                                                     count=0).items()):
                raise AssertionError(f"{name} {method}: spatial_join_count "
                                     f"launched {per_join}, want {want} "
                                     f"and no mask or count")
            mstats = {}
            rid, sid, uniq = engine.masj_pairs(plan, max_pairs_per_tile=max_n,
                                               stats=mstats)
            masj = int(uniq.sum())
            tpd = plan.r_tiles.shape[1]
            live = plan.live_r * plan.live_s
            results[name, method] = dict(
                exact=exact, raw=raw, masj=masj, max_n=max_n,
                overlapping=st["overlapping"],
                truncated_tiles=mstats["truncated_tiles"])
            emit(dict(
                phase="join", input=name, method=method,
                n_r=r.shape[0], n_s=s.shape[0], payload=PAYLOAD,
                plan_s=median(plan_s), join_s=median(join_s),
                plan_s_all=plan_s, join_s_all=join_s,
                raw_count_s=median(raw_s), raw_count_s_all=raw_s,
                k=st["k"], cap_r=st["cap_r"], cap_s=st["cap_s"],
                lambda_r=st["lambda_r"], lambda_s=st["lambda_s"],
                skew=st["skew"], exact=exact, raw=raw, masj_pairs=masj,
                max_tile_pairs=max_n, gathered_pairs=mstats["pairs"],
                truncated_tiles=mstats["truncated_tiles"],
                live_tests=int(live.sum()), live_tiles=int((live > 0).sum()),
                padded_pair_table_bytes=2 * 4 * tpd * max_n,
                launches_per_join=per_join,
                raw_count_launches=raw_launches,
                max_memory_allocated=torch.cuda.max_memory_allocated()))
            if method in ("bsp", "hc"):
                # a window of about 0.2 s: one call of a few ms is too
                # short for the profiler to report its device work
                reps = max(1, min(40, int(0.2 / median(join_s)) + 1))
                dev_ms, top = device_busy(torch, lambda: (
                    engine.spatial_join_count(plan,
                                              max_pairs_per_tile=max_n)),
                                          reps)
                counted = dict(mkernel.LAUNCHES)
                old_s, old_raw_s = [], []
                for _ in range(3):
                    (old, _), secs = timed_s(torch, lambda: old_join(
                        torch, plan, st["overlapping"], max_n))
                    old_s.append(secs)
                    _, secs = timed_s(torch, lambda: old_raw_counts(
                        torch, plan))
                    old_raw_s.append(secs)
                mkernel.LAUNCHES.update(counted)     # the yardsticks'
                if old != exact:
                    raise AssertionError(f"{name} {method}: the per-tile "
                                         f"join counts {old}, not {exact}")
                emit(dict(phase="join_device", input=name, method=method,
                          device_ms_per_join=dev_ms, profiled_joins=reps,
                          top_device=top,
                          join_s=median(join_s), old_join_s=median(old_s),
                          old_join_s_all=old_s, raw_count_s=median(raw_s),
                          old_raw_count_s=median(old_raw_s),
                          old_raw_count_s_all=old_raw_s))
                plans[name, method] = plan
            if method == "bsp":
                j = int(torch.from_numpy(live)[0].argmax())
                nr, ns = int(plan.live_r[0, j]), int(plan.live_s[0, j])
                tiles[name] = (plan.r_tiles[0, j, :nr].clone(),
                               plan.s_tiles[0, j, :ns].clone())
                pairs[name] = (rid[uniq], sid[uniq])
            del plan, rid, sid, uniq
    launches = dict(mkernel.LAUNCHES, **hkernel.LAUNCHES)
    for k in ("raw_counts", "rp_counts", "pair_list", "encode"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched on the join path: "
                                 f"{launches}")
    for k in ("count", "mask", "encode_v1"):
        if launches[k]:
            raise AssertionError(f"{k} was launched on the join path: "
                                 f"{launches}")
    return results, launches, tiles, pairs, plans


def join_check_phase(torch, inputs, results, pairs):
    """The join's exactness against the unpartitioned oracle and a
    brute force of sampled objects; raises on any disagreement."""
    from repro_torch.core import geometry
    from repro_torch.kernels.mbr_join import ops as mops

    for name, (r, s) in inputs.items():
        rows = [results[name, m] for m in METHODS]
        exact = rows[0]["exact"]
        oracle, oracle_s = timed_s(torch, lambda: int(mops.join_count(r, s)))
        for m, row in zip(METHODS, rows):
            if row["exact"] != exact:
                raise AssertionError(f"{name}: {m} counts {row['exact']}, "
                                     f"{METHODS[0]} {exact}")
            if not row["overlapping"] and row["exact"] != row["masj"]:
                raise AssertionError(f"{name}: {m} rp {row['exact']} != "
                                     f"MASJ pairs {row['masj']}")
            if row["raw"] < row["exact"] or row["truncated_tiles"]:
                raise AssertionError(f"{name}: {m} raw {row['raw']} or "
                                     f"truncation {row['truncated_tiles']}")
        if oracle != exact:
            raise AssertionError(f"{name}: exact {exact} != unpartitioned "
                                 f"join_count {oracle}")
        g = torch.Generator(device=r.device).manual_seed(SEED + 3)
        sample = torch.randperm(r.shape[0], generator=g,
                                device=r.device)[:JOIN_SAMPLE]
        rid, _ = pairs[name]
        got = torch.bincount(rid.long(), minlength=r.shape[0])[sample]
        want = torch.cat([
            geometry.intersects(r[sample[i:i + 64], None, :],
                                s[None, :, :]).sum(1)
            for i in range(0, JOIN_SAMPLE, 64)])
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: bsp partner counts differ from "
                                 f"the brute force")
        emit(dict(phase="join_check", input=name, exact=exact,
                  unpartitioned=oracle, unpartitioned_s=oracle_s,
                  all_six_equal=True, rp_equals_masj=True,
                  sampled_objects=JOIN_SAMPLE,
                  sampled_partners=int(want.sum()), truncated_tiles=0))


def encode_sass_ops() -> dict:
    """The built encode kernel's SASS (``cuobjdump -sass``): the
    instructions of ``encode_vec_kernel``'s grid-stride loop (the span of
    its widest backward branch), NOPs left out, over the four points an
    iteration encodes -> ops per point, the loop's length and its
    opcodes."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.hilbert import kernel as hkernel

    tool = Path(cuda_build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(hkernel.build())],
                          capture_output=True, text=True, check=True).stdout
    body = next(f for f in re.split(r"\n\s*Function : ", sass)[1:]
                if "encode_vec_kernel" in f.split("\n", 1)[0])
    ops, at, labels = [], {}, {}
    for line in body.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if lab:
            labels[lab.group(1)] = len(ops)
        elif ins:
            at[int(ins.group(1), 16)] = len(ops)
            ops.append(ins.group(2))
    loops = []
    for i, op in enumerate(ops):
        jump = re.search(r"\bBRA\b.*?(\.L_x_\d+|0x[0-9a-f]+)", op)
        if jump:
            tgt = jump.group(1)
            j = labels.get(tgt) if tgt.startswith(".L") else at.get(
                int(tgt, 16))
            if j is not None and j <= i:
                loops.append((i - j, j, i))
    if not loops:
        raise AssertionError("no loop found in encode_vec_kernel's SASS")
    _, j, i = max(loops)
    loop = [re.sub(r"^@!?U?P\w+\s+", "", op).split()[0]
            for op in ops[j:i + 1]]
    loop = [op for op in loop if not op.startswith("NOP")]
    counts: dict[str, int] = {}
    for op in loop:
        counts[op] = counts.get(op, 0) + 1
    return dict(ops_per_point=len(loop) / 4, loop_instructions=len(loop),
                points_per_iteration=4, kernel_instructions=len(ops),
                opcodes=dict(sorted(counts.items(), key=lambda kv: -kv[1])))


def new_kernel_phase(torch, inputs, tiles, plans, results, launches):
    """encode on the 8 M merged pi centroids; count and mask on the
    largest live tile of each bsp join; the batched rp count on the bsp
    plans and the batched pair list on the hc plans, whole.  Bit-equal
    to the plain versions, else raise."""
    from repro_torch.core import geometry, hilbert
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.hilbert import ref as href
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.kernels.mbr_join import ops as mops
    from repro_torch.kernels.mbr_join import ref as mref

    def compare(name, k, plain):
        got = k()
        want, plain_s = timed_s(torch, plain)
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name} differs from its plain version")
        return dict(ms=cuda_ms(torch, k, 10), plain_ms=plain_s * 1e3)

    def entry(name, source, case, bytes_, ops_, shape, rate=FP32_OPS_PER_S):
        b_ms, o_ms = bytes_ / HBM_BYTES_PER_S * 1e3, ops_ / rate * 1e3
        return dict(name=name, route="cuda", source=source,
                    replaces=NEW_CASES[name], launches=launches[name],
                    max_abs_err=0, ms=case["ms"], plain_ms=case["plain_ms"],
                    bound_ms=max(b_ms, o_ms),
                    bound_by="bytes" if b_ms >= o_ms else "operations",
                    library_ms=None, bit_equal=True, shape=shape)

    r, s = inputs["pi"]
    merged = torch.cat([r, s])
    order = hilbert.DEFAULT_ORDER
    sass = encode_sass_ops()
    g = torch.Generator(device=r.device).manual_seed(SEED + 4)
    grids = {
        "pi_centroids": [c.contiguous() for c in hilbert.quantize(
            geometry.centroids(merged), geometry.universe(merged))],
        "staging_launch": [torch.randint(0, 1 << order, (HILBERT_SLOTS,),
                                         generator=g, device=r.device,
                                         dtype=torch.int32)
                           for _ in range(2)]}
    cases = {}
    for inp, (gx, gy) in grids.items():
        n = gx.shape[0]
        case = compare("hilbert_encode", lambda: hkernel.encode(gx, gy, order),
                       lambda: href.encode(gx, gy, order))
        if not torch.equal(hkernel.encode_v1(gx, gy, order),
                           hkernel.encode(gx, gy, order)):
            raise AssertionError("encode_v1 differs from encode")
        turns = [cuda_ms(torch, fn, 10) for fn in (
            lambda: hkernel.encode_v1(gx, gy, order),
            lambda: hkernel.encode(gx, gy, order),
            lambda: hkernel.encode(gx, gy, order),
            lambda: hkernel.encode_v1(gx, gy, order))]
        cases[inp] = dict(
            case, ms=(turns[1] + turns[2]) / 2,
            v1_ms=(turns[0] + turns[3]) / 2,
            turns_ms=turns, bytes=16 * n, ops=sass["ops_per_point"] * n,
            shape=dict(n=n, order=order))
    hkernel.LAUNCHES["encode_v1"] = 0     # the yardstick's
    main = cases["pi_centroids"]
    e = entry("hilbert_encode", HILBERT_SOURCE, main, main["bytes"],
              main["ops"], main["shape"], INT_OPS_PER_S)
    e.update(old_design="encode_v1 (one thread a point, one bit plane a "
             "step)", old_design_ms=main["v1_ms"], sass=sass,
             cases={k: dict(v, bound_ms=max(
                 v["bytes"] / HBM_BYTES_PER_S,
                 v["ops"] / INT_OPS_PER_S) * 1e3)
                 for k, v in cases.items()})
    entries = [e]
    del grids
    for name in ("mbr_count", "mbr_mask"):
        cases = {}
        for inp, (rt, st) in tiles.items():
            r4 = mops.pad_cm(rt, mops.DEFAULT_BR)
            s4 = mops.pad_cm(st, mops.DEFAULT_BS)
            np_, mp = r4.shape[1], s4.shape[1]
            if name == "mbr_count":
                c = compare(name, lambda: mkernel.count(
                    r4, s4, mops.DEFAULT_BR, mops.DEFAULT_BS),
                    lambda: mref.count_cm(r4, s4, mops.DEFAULT_BR,
                                          mops.DEFAULT_BS))
                cells = (np_ // mops.DEFAULT_BR) * (mp // mops.DEFAULT_BS)
                out_bytes = 4 * cells
            else:
                c = compare(name, lambda: mkernel.mask(r4, s4),
                            lambda: mref.mask_cm(r4, s4))
                out_bytes = np_ * mp
            cases[inp] = dict(c, bytes=16 * (np_ + mp) + out_bytes,
                              ops=4 * np_ * mp,
                              shape=dict(live_r=rt.shape[0],
                                         live_s=st.shape[0], n_pad=np_,
                                         m_pad=mp))
        main = cases["pi"]
        e = entry(name, MBR_SOURCE, main, main["bytes"], main["ops"],
                  main["shape"])
        e["cases"] = {
            k: dict(v, bound_ms=max(v["bytes"] / HBM_BYTES_PER_S,
                                    v["ops"] / FP32_OPS_PER_S) * 1e3)
            for k, v in cases.items()}
        entries.append(e)
    for name, method in BATCHED.items():
        cases = {inp: batched_case(torch, name, plans[inp, method],
                                   results[inp, method])
                 for inp in JOIN_INPUTS}
        main = cases["pi"]
        e = entry(name, MBR_SOURCE, main, main["bytes"], main["ops"],
                  main["shape"])
        e.update(old_design=main["old_design"],
                 old_design_ms=main["old_design_ms"],
                 cases={k: dict(v, bound_ms=max(
                     v["bytes"] / HBM_BYTES_PER_S,
                     v["ops"] / FP32_OPS_PER_S) * 1e3)
                     for k, v in cases.items()})
        entries.append(e)
    by_name = {e["name"]: e for e in entries}
    raw, rp = by_name["mbr_raw_counts"], by_name["mbr_rp_counts"]
    raw["rp_counts_ms_same_plans"] = {k: rp["cases"][k]["ms"]
                                      for k in JOIN_INPUTS}
    return entries


def batched_case(torch, name, plan, result):
    """One batched join pass on a whole plan against its plain version
    (bit-equal) and the per-tile table path on the same plan (the same
    counts, or the same pair list) -> its case row: kernel ms (CUDA
    events over 10 launches; the pair list's host read included, its
    stages apart), plain and old ms (host clock), bytes and operations
    of its bound."""
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.kernels.mbr_join import ref as mref
    from repro_torch.query import engine

    meta = engine._meta(plan)
    rt, st, rid, sid = (a[0] for a in (plan.r_tiles, plan.s_tiles,
                                       plan.r_ids, plan.s_ids))
    lr, ls = plan.live_r[0], plan.live_s[0]
    live = lr * ls
    tests = int(live.sum())
    box_bytes = 16 * int(lr[live > 0].sum() + ls[live > 0].sum())
    counted = dict(mkernel.LAUNCHES)
    if name == "mbr_rp_counts":
        tb, uni = plan.tile_boxes[0], plan.universe
        k = lambda: mkernel.rp_counts(rt, st, tb, uni, meta)  # noqa: E731
        plain = lambda: mref.tile_rp_counts(rt, st, tb, uni, lr, ls)  # noqa
        got = k()
        want, plain_s = timed_s(torch, plain)
        (_, old), old_s = timed_s(torch, lambda: old_join(torch, plan, False,
                                                          0))
        if not (torch.equal(got, want) and torch.equal(got, old)):
            raise AssertionError(f"{name} differs from its plain version or "
                                 f"the per-tile path")
        out_bytes, stages = 8 * rt.shape[0], {}
        listed = None
    elif name == "mbr_raw_counts":
        k = lambda: mkernel.raw_counts(rt, st, meta)  # noqa: E731
        got = k()
        want, plain_s = timed_s(torch, lambda: mref.tile_raw_counts(
            rt, st, lr, ls))
        old, old_s = timed_s(torch, lambda: old_raw_counts(torch, plan))
        if not (torch.equal(got, want) and torch.equal(got, old)):
            raise AssertionError(f"{name} differs from its plain version or "
                                 f"the per-tile path")
        out_bytes, stages = 8 * rt.shape[0], {}
        listed = None
    else:
        max_pairs = result["max_n"]
        k = lambda: mkernel.pair_list(rt, st, rid, sid, meta,  # noqa: E731
                                      max_pairs)
        got = k()
        want, plain_s = timed_s(torch, lambda: mref.tile_pair_list(
            rt, st, rid, sid, lr, ls, max_pairs))
        (_, old), old_s = timed_s(torch, lambda: old_join(torch, plan, True,
                                                          max_pairs))
        if not (all(torch.equal(g, w) for g, w in zip(got, want))
                and torch.equal(got[0], old[0])
                and torch.equal(got[1], old[1])):
            raise AssertionError(f"{name} differs from its plain version or "
                                 f"the per-tile path")
        listed = int(got[0].shape[0])
        cells = mkernel.pair_row_counts(rt, st, rid, sid, meta)
        stages = dict(
            count_ms=cuda_ms(torch, lambda: mkernel.pair_row_counts(
                rt, st, rid, sid, meta), 10),
            scan_emit_ms=cuda_ms(torch, lambda: mkernel.emit_pairs(
                rt, st, rid, sid, meta, cells, max_pairs), 10))
        out_bytes = PAIR_BYTES * listed
        box_bytes += 4 * int(lr[live > 0].sum() + ls[live > 0].sum())
    ms = cuda_ms(torch, k, 10)
    mkernel.LAUNCHES.update(counted)      # the comparison's launches
    del got, want, old
    old_design = ("per tile: pad_cm and the count kernel's block sums"
                  if name == "mbr_raw_counts" else "per tile: the mask "
                  "table kernel, then rp_own_mask and a sum, or nonzero")
    return dict(ms=ms, plain_ms=plain_s * 1e3, bytes=box_bytes + out_bytes,
                ops=4 * tests, old_design=old_design,
                old_design_ms=old_s * 1e3, **stages,
                shape=dict(tiles=int(rt.shape[0]),
                           live_tiles=int((live > 0).sum()),
                           work_items=meta.items, row_cells=meta.rows,
                           live_tests=tests, pairs=listed,
                           cap_r=int(rt.shape[1]), cap_s=int(st.shape[1])))


def lm_model(torch, dev):
    """The published Mamba2-1.3B configuration, random float32 weights
    from a seeded generator on the card."""
    from repro_torch import configs
    from repro_torch.models import api

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = configs.get(LM_ARCH)
    model = api.build(cfg, dev)
    params = model.init_params(torch.Generator(dev).manual_seed(SEED))
    return cfg, model, params


def prefill_batch(torch, dev, cfg):
    g = torch.Generator(dev).manual_seed(SEED + 4)
    return {"tokens": torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_L),
                                    generator=g, device=dev)}


def lm_prefill_phase(torch, dev, cfg, model, params):
    """make_prefill_step on PREFILL_B x PREFILL_L tokens -> the SSD
    launches of the timed prefills."""
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.models import api

    step = api.make_prefill_step(model)
    batch = prefill_batch(torch, dev, cfg)
    warm, warm_s = timed_s(torch, lambda: step(params, batch))
    torch.cuda.reset_peak_memory_stats()
    skernel.reset_launches()
    secs = []
    for _ in range(3):
        logits, t = timed_s(torch, lambda: step(params, batch))
        secs.append(t)
    launches = skernel.LAUNCHES["intra_chunk"]
    if skernel.LAUNCHES["intra_chunk_v1"]:
        raise AssertionError("the prefill launched the FFMA SSD kernel")
    peak = torch.cuda.max_memory_allocated()
    if not (logits.shape == (PREFILL_B, cfg.vocab_padded)
            and torch.isfinite(logits[:, :cfg.vocab]).all()
            and bool((logits[:, cfg.vocab:] == -1e9).all())):
        raise AssertionError("prefill logits are not finite, of the wrong "
                             "shape, or the padded vocab is not masked")
    dev_ms, top = device_busy(torch, lambda: step(params, batch), 1)
    wall = median(secs)
    tokens = PREFILL_B * PREFILL_L
    emit(dict(
        phase="lm_prefill", arch=cfg.name, n_params=cfg.n_params(),
        n_layers=cfg.n_layers, batch=PREFILL_B, seq=PREFILL_L,
        dtype=cfg.dtype, seconds=wall, seconds_all=secs, first_s=warm_s,
        tokens_per_s=tokens / wall, max_memory_allocated=peak,
        ssd_launches=launches, ssd_launches_per_prefill=launches / 3,
        device_ms=dev_ms, idle_share=1 - dev_ms / (wall * 1e3),
        top_device=top,
        repeat_max_abs_diff=float((logits - warm).abs().max()),
        model_flops=2 * cfg.n_params() * tokens,
        model_flops_bound_s=2 * cfg.n_params() * tokens / BF16_FLOPS_PER_S))
    if launches != 3 * cfg.n_layers:
        raise AssertionError(f"the SSD kernel launched {launches} times in "
                             f"3 prefills of {cfg.n_layers} layers")
    return launches


def prefill_layer0_inputs(torch, dev, cfg, model, params):
    """One more prefill of the same batch, keeping layer 0's SSD inputs
    (run after the timed phases, so their peaks do not hold them)."""
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.models import api

    step = api.make_prefill_step(model)
    captured = []
    launch = skernel.intra_chunk

    def capture(*args):
        if not captured:
            captured.append(args)
        return launch(*args)

    skernel.intra_chunk = capture
    try:
        step(params, prefill_batch(torch, dev, cfg))
    finally:
        skernel.intra_chunk = launch
    return captured[0]


def lm_decode_phase(torch, dev, cfg, model, params):
    """The serve launcher's greedy loop at DECODE_B -> tokens/s."""
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.launch import serve
    from repro_torch.models import api

    g = torch.Generator(dev).manual_seed(SEED + 5)
    prompt = torch.randint(0, cfg.vocab, (DECODE_B, DECODE_PROMPT),
                           generator=g, device=dev)
    serve.generate(model, params, prompt[:, :2], 2)        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    skernel.reset_launches()
    stamps = [time.perf_counter()]

    def on_step(_pos):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    out = serve.generate(model, params, prompt, DECODE_GEN, on_step)
    wall = stamps[-1] - stamps[0]
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    if not (out.shape == (DECODE_B, DECODE_GEN)
            and bool(((out >= 0) & (out < cfg.vocab)).all())):
        raise AssertionError("decode produced tokens out of the vocab")
    serve_step = api.make_serve_step(model)
    cache = model.init_cache(DECODE_B, 4)
    dev_ms, top = device_busy(
        torch, lambda: serve_step(params, cache, prompt[:, 0], 0), 3)
    p50 = pct(step_ms, 0.5)
    emit(dict(
        phase="lm_decode", arch=cfg.name, batch=DECODE_B,
        prompt=DECODE_PROMPT, gen=DECODE_GEN, steps=len(step_ms),
        seconds=wall, tokens_per_s=DECODE_B * DECODE_GEN / wall,
        p50_step_ms=p50, p99_step_ms=pct(step_ms, 0.99),
        device_ms_per_step=dev_ms, idle_share=1 - dev_ms / p50,
        top_device=top, ssd_launches=skernel.LAUNCHES["intra_chunk"],
        state_bytes=cfg.n_layers * DECODE_B * cfg.ssm_heads * cfg.ssm_state
        * cfg.ssm_head_dim * 4,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        sample=out[0, :16].tolist()))


def ssd_plain_blocked(torch, sref, x, dt, cl, b, c, chunk, rows=64):
    """The plain version over the whole input, in blocks of ``rows``
    chunks (its (B, nc, H, Q, Q) tables would be 17 GB at once)."""
    bs, l, h, p = x.shape
    out = torch.empty_like(x)
    step = rows * chunk
    for bi in range(bs):
        for t in range(0, l, step):
            sl = (slice(bi, bi + 1), slice(t, t + step))
            out[sl] = sref.intra_chunk_grouped(x[sl], dt[sl], cl[sl], b[sl],
                                               c[sl], chunk)
    return out


def ssd_inputs_random(torch, dev, bs, l, h, p, g, s, chunk):
    """tests/test_kernels_ssd.py's distributions, on the card."""
    gen = torch.Generator(dev).manual_seed(SEED + 6)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = normal(bs, l, h, p)
    dt = torch.nn.functional.softplus(normal(bs, l, h)) * 0.1
    cl = torch.cumsum((-dt * 0.5).reshape(bs, l // chunk, chunk, h),
                      2).reshape(bs, l, h)
    return x, dt, cl, normal(bs, l, g, s) * 0.3, normal(bs, l, g, s) * 0.3


def ssd_bound(x, b, chunk):
    """Least bytes (inputs read once, y written once) and operations
    (causal G once per (batch, chunk, group), causal M . X per head, and
    four operations per causal element of M) of one launch."""
    bs, l, h, p = x.shape
    g, s = b.shape[2], b.shape[3]
    nc = l // chunk
    tri = chunk * (chunk + 1) // 2
    bytes_ = 4 * (2 * bs * l * h * p + 2 * bs * l * h + 2 * bs * l * g * s)
    flops = (bs * nc * g * tri * 2 * s + bs * nc * h * tri * 2 * p
             + bs * nc * h * tri * 4)
    return bytes_, flops


def lm_check_phase(torch, dev, cfg, model, params, launches):
    """Kernel against plain, float32 prefill against decode, and the
    launch count -> the SSD kernel's row."""
    import dataclasses
    from repro_torch.kernels.ssd import kernel as skernel
    from repro_torch.kernels.ssd import ref as sref
    from repro_torch.models import lm

    chunk = 128
    layer0 = prefill_layer0_inputs(torch, dev, cfg, model, params)
    sets = {"layer0": layer0[:5]}
    x0 = layer0[0]
    sets["random"] = ssd_inputs_random(
        torch, dev, 1, 8192, x0.shape[2], x0.shape[3], layer0[3].shape[2],
        layer0[3].shape[3], chunk)
    cases = {}
    for name, args in sets.items():
        with torch.no_grad():
            got = skernel.intra_chunk(*args, chunk)
            got_v1 = skernel.intra_chunk_v1(*args, chunk)
            want, plain_s = timed_s(torch, lambda: ssd_plain_blocked(
                torch, sref, *args, chunk))
        err = (got - want).abs()
        ok = bool((err <= SSD_TOL + SSD_TOL * want.abs()).all())
        ms, ms_v1 = [], []
        for _ in range(2):                     # in turns: new, old, ...
            ms.append(cuda_ms(torch, lambda: skernel.intra_chunk(
                *args, chunk), 10))
            ms_v1.append(cuda_ms(torch, lambda: skernel.intra_chunk_v1(
                *args, chunk), 10))
        cases[name] = dict(max_abs_err=float(err.max()), ok=ok,
                           max_abs=float(want.abs().max()),
                           max_abs_err_v1=float((got_v1 - want).abs().max()),
                           plain_ms=plain_s * 1e3, ms=min(ms), ms_all=ms,
                           v1_ms=min(ms_v1), v1_ms_all=ms_v1,
                           shape=list(args[0].shape),
                           inputs={k: dict(std=float(a.std()),
                                           max_abs=float(a.abs().max()))
                                   for k, a in zip(("x", "dt", "cl", "b",
                                                    "c"), args)})
        del got, got_v1, want, err
        if not ok:
            raise AssertionError(f"SSD kernel ({name}) differs from its "
                                 f"plain version beyond {SSD_TOL}: "
                                 f"{cases[name]}")
    bytes_, flops = ssd_bound(x0, layer0[3], chunk)
    b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    o_ms = flops / FP32_OPS_PER_S * 1e3
    del sets, layer0, x0
    torch.cuda.empty_cache()

    # float32 prefill through the kernel against decode through the
    # recurrence, at full width and depth
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator(dev).manual_seed(SEED + 7)
    toks = torch.randint(0, cfg.vocab, (CHECK_B, CHECK_L), generator=g,
                         device=dev)
    skernel.reset_launches()
    with torch.no_grad():
        tf, _ = lm.forward(params, toks, cfg32, logits_mode="all")
        tf_launches = skernel.LAUNCHES["intra_chunk"]
        cache = lm.init_cache(cfg32, CHECK_B, CHECK_L, dev)
        err, rel, undecided, flipped, within = 0.0, 0.0, 0, 0, True
        for pos in range(CHECK_L):
            logits, cache = lm.decode_step(params, cache, toks[:, pos], pos,
                                           cfg32)
            want = tf[:, pos, :cfg.vocab]
            d = (logits[:, :cfg.vocab] - want).abs()
            err = max(err, float(d.max()))
            rel = max(rel, float((d / (want.abs() + 1e-30)).max()))
            within &= bool((d <= LM_TOL + LM_TOL * want.abs()).all())
            # a token may flip where each logit can move by the tolerance
            top2 = torch.topk(want, 2, dim=-1).values
            decided = (top2[:, 0] - top2[:, 1]) > 2 * LM_TOL
            undecided += int((~decided).sum())
            flipped += int((decided & (logits[:, :cfg.vocab].argmax(-1)
                                       != want.argmax(-1))).sum())
    decode_launches = skernel.LAUNCHES["intra_chunk"] - tf_launches
    ok = (tf_launches == cfg.n_layers and decode_launches == 0
          and flipped == 0 and bool(torch.isfinite(tf).all()))
    emit(dict(phase="lm_check", prefill_vs_decode=dict(
        dtype="float32", batch=CHECK_B, seq=CHECK_L, max_abs_err=err,
        max_rel_err=rel, tolerance=LM_TOL, within_tolerance=within,
        undecided_positions=undecided, flipped_tokens=flipped,
        prefill_ssd_launches=tf_launches, decode_ssd_launches=decode_launches),
        ssd_kernel_cases=cases, main_path_ssd_launches=launches))
    if not ok:
        raise AssertionError("float32 prefill and decode disagree, or the "
                             "kernel was launched off its path")
    if not within:
        raise AssertionError(f"float32 prefill and decode differ by {err} "
                             f"(tolerance {LM_TOL})")
    main = cases["layer0"]
    return dict(
        name="ssd_intra_chunk", route="cuda", source=SSD_SOURCE,
        replaces=SSD_TPU, launches=launches,
        max_abs_err=max(c["max_abs_err"] for c in cases.values()),
        ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=max(b_ms, o_ms),
        bound_by="bytes" if b_ms >= o_ms else "operations",
        library_ms=None, tolerance=SSD_TOL,
        old_design="ssd_intra_chunk_v1 (scalar FFMA, one block an SM)",
        old_design_ms=main["v1_ms"],
        launches_per_prefill=launches // 3, bytes=bytes_, flops=flops,
        shape=dict(zip("blhp", main["shape"]), q=chunk), cases=cases)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda is not "
              "available", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.hilbert import kernel as hkernel
    from repro_torch.kernels.mbr_join import kernel as mkernel
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.kernels.ssd import kernel as skernel

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    wall = {}
    t0 = time.perf_counter()
    libs = cuda_build.build_all([kernel.SOURCE, hkernel.SOURCE,
                                 mkernel.SOURCE, skernel.SOURCE])
    ptxas = {lib.name: [ln.strip() for ln in lib.with_suffix(".log")
                        .read_text().splitlines()
                        if "registers" in ln or "spill" in ln]
             for lib in libs}
    wall["build_s"] = time.perf_counter() - t0
    emit(dict(phase="build", seconds=wall["build_s"],
              libraries=[lib.name for lib in libs], device=name,
              nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
              ptxas=ptxas))

    t0 = time.perf_counter()
    (servers, mbrs, qc, qi, pruned_x, launches, calls,
     serve_encode) = serve_phase(torch, dev)
    t1 = time.perf_counter()
    pts, pruned_knn, knn_launches = knn_phase(torch, servers, mbrs, dev)
    t2 = time.perf_counter()
    dense_launches = dense_phase(torch, servers["x"], mbrs, qc, qi, pts,
                                 pruned_x, pruned_knn)
    t3 = time.perf_counter()
    entries = kernel_phase(torch, servers, qc, qi, pts, launches, calls)
    entries += dense_kernel_phase(torch, servers["x"], qc, qi, pts,
                                  dense_launches)
    for e in entries:
        if e["name"] in CASES:
            e["knn_launches"] = knn_launches[e["name"]]
        emit(dict(phase="kernel", **e))
    t4 = time.perf_counter()
    wall.update(serve_s=t1 - t0, knn_s=t2 - t1, dense_s=t3 - t2,
                kernels_s=t4 - t3)
    del servers, mbrs, qc, qi, pruned_x, pts, pruned_knn
    torch.cuda.empty_cache()

    inputs = join_inputs(torch, dev)
    part_encode = partition_phase(torch, *inputs["pi"])
    t5 = time.perf_counter()
    results, join_launches, tiles, pairs, plans = join_phase(torch, dev,
                                                             inputs)
    t6 = time.perf_counter()
    join_check_phase(torch, inputs, results, pairs)
    t7 = time.perf_counter()
    main_launches = dict(
        hilbert_encode=serve_encode + part_encode + join_launches["encode"],
        mbr_count=join_launches["count"], mbr_mask=join_launches["mask"],
        mbr_rp_counts=join_launches["rp_counts"],
        mbr_raw_counts=join_launches["raw_counts"],
        mbr_pair_list=join_launches["pair_list"])
    new_entries = new_kernel_phase(torch, inputs, tiles, plans, results,
                                   main_launches)
    for e in new_entries:
        e["launches_by_path"] = (
            dict(serve_hilbert_staging=serve_encode, partition=part_encode,
                 join=join_launches["encode"])
            if e["name"] == "hilbert_encode" else
            dict(join=join_launches[e["name"][4:]]))
        emit(dict(phase="kernel", **e))
    entries += new_entries
    t8 = time.perf_counter()
    wall.update(partition_s=t5 - t4, join_s=t6 - t5, join_check_s=t7 - t6,
                new_kernels_s=t8 - t7)
    del inputs, results, tiles, pairs, plans
    torch.cuda.empty_cache()

    cfg, model, params = lm_model(torch, dev)
    ssd_launches = lm_prefill_phase(torch, dev, cfg, model, params)
    t9 = time.perf_counter()
    lm_decode_phase(torch, dev, cfg, model, params)
    t10 = time.perf_counter()
    ssd_entry = lm_check_phase(torch, dev, cfg, model, params, ssd_launches)
    emit(dict(phase="kernel", **ssd_entry))
    entries.append(ssd_entry)
    wall.update(lm_prefill_s=t9 - t8, lm_decode_s=t10 - t9,
                lm_check_s=time.perf_counter() - t10)
    emit(dict(phase="wall", **wall))
    emit({"kernels": [dict(
        {k: e[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **{k: e[k] for k in ("bit_equal", "tolerance", "bound_ms_full_cap",
                             "design", "table_kernel", "table_ms",
                             "old_extraction_ms", "old_design",
                             "old_design_ms") if k in e})
        for e in entries]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
