#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's range-serving path on one CUDA card.

    python3 chip_smoke.py            # full size: N = 8,000,000 osm-like objects

Phases, each printing one JSON line:

1. build  -- compile the range-probe kernels from the checkout's sources
   with nvcc (sm_90a) and report the compiler's register/spill summary.
2. serve  -- with every kernel launch count at 0: generate N osm-like
   objects on the card (seeded), partition them with ``bsp`` at payload
   4096 and stage them twice (``local_index="x"`` and ``"off"``), then
   serve 20 ``range_counts`` batches of Q = 4096 boxes (centres uniform,
   half-extents uniform in [0, 0.03]) and 5 ``range_ids`` batches of
   1024 boxes (half-extents in [0, 0.003], max_hits = 1024) through
   each server.  Counts of "x" must equal those of "off"; 1024 queries
   of the first counts batch and every query of the first ids batch
   are checked against a blocked brute force on the card, overflow
   flags included.  The launch counts are read right after.
3. kernels -- each of the four kernels against its plain PyTorch
   version on the card, at the shapes the serving path gives it (a
   routed counts batch; the ids executor's largest hit-table block):
   the path's own inputs (staged alive mask, bounding chunk boxes),
   then ``alive`` None and a random mask and, for the skip kernels,
   chunk boxes that do not bound their members.  Results must be
   bit-equal.  Kernel times come from CUDA events, plain times from
   the host clock.

Then one ``{"kernels": [...]}`` line, the card's name and power limit
as ``nvidia-smi`` prints them, and ``{"ok": true, "device": ...}`` as
the last line.  Any failure raises and the script exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "port"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_OPS_PER_S = 67e12         # H100 SXM, float32 outside the tensor cores
PAYLOAD, MAX_HITS, SEED = 4096, 1024, 0
N = 8_000_000          # osm-like objects served
Q, Q_IDS = 4096, 1024  # boxes per range_counts / range_ids batch
BATCHES, ID_BATCHES = 20, 5
CHECK_Q = 1024         # queries of the first counts batch brute-forced
CASES = {  # entry point -> (kernel line name, TPU kernel it replaces)
    "gather_count_skip": "src/repro/kernels/range_probe/kernel.py:467",
    "gather_mask_skip": "src/repro/kernels/range_probe/kernel.py:495",
    "gather_count": "src/repro/kernels/range_probe/kernel.py:190",
    "gather_mask": "src/repro/kernels/range_probe/kernel.py:215",
}


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
    from repro_torch.kernels.range_probe import kernel
    from repro_torch.serve import ServeConfig, SpatialServer

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cbatches = [qboxes(torch, g, Q, 0.03, dev)
                for _ in range(BATCHES)]
    ibatches = [qboxes(torch, g, Q_IDS, 0.003, dev)
                for _ in range(ID_BATCHES)]

    kernel.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mbrs = spatial_gen.osm_like(N, seed=SEED, device=dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0

    servers, results = {}, {}
    for li in ("x", "off"):
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
        c_sorted, i_sorted = sorted(c_ms), sorted(i_ms)
        pct = lambda xs, p: xs[min(len(xs) - 1, int(p * len(xs)))]  # noqa
        emit(dict(
            phase="serve", local_index=li, n=N, payload=PAYLOAD,
            t=srv.stats["t"], cap=srv.stats["cap"],
            t_live=srv.stats["t_live"], chunks=srv.stats["chunks"],
            replication=srv.stats["replication"], stage_s=stage_s,
            gen_s=gen_s, resident_tile_bytes=srv.resident_tile_bytes(),
            counts=dict(q=Q, batches=len(c_ms),
                        qps=Q * len(c_ms) / (sum(c_ms) / 1e3),
                        p50_ms=pct(c_sorted, 0.5), p99_ms=pct(c_sorted, 0.99),
                        f_max=f_max,
                        fanout_mean=sum(fan) / len(fan),
                        device_ms_per_batch=dev_ms, top_device=top,
                        chunk_skip_rate=srv.chunk_skip_rate(cbatches[0])),
            ids=dict(q=Q_IDS, batches=len(i_ms),
                     qps=Q_IDS * len(i_ms) / (sum(i_ms) / 1e3),
                     p50_ms=pct(i_sorted, 0.5), p99_ms=pct(i_sorted, 0.99),
                     f_max=i_fmax, device_ms_per_batch=dev_ids_ms,
                     top_device=top_ids),
            max_memory_allocated=torch.cuda.max_memory_allocated()))
    launches = dict(kernel.LAUNCHES)

    for a, b in zip(results["x"]["counts"], results["off"]["counts"]):
        if not torch.equal(a, b):
            raise AssertionError('counts of local_index "x" and "off" differ')
    for a, b in zip(results["x"]["ids"], results["off"]["ids"]):
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError('ids of local_index "x" and "off" differ')
    check_counts(torch, geometry, mbrs, cbatches[0][:CHECK_Q],
                 results["x"]["counts"][0][:CHECK_Q])
    hit_ids, cnt, ovf = results["x"]["ids"][0]
    n_over = check_ids(torch, geometry, mbrs, ibatches[0], hit_ids, cnt, ovf,
                       MAX_HITS)
    emit(dict(phase="check", x_equals_off=True, brute_force_counts=CHECK_Q,
              brute_force_ids=Q_IDS, overflowed_queries=n_over,
              hits_in_first_counts_batch=int(results["x"]["counts"][0].sum())))
    for name in CASES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched on the serving "
                                 f"path: {launches}")
    # per server: warm-up + timed + profiled batches
    calls = dict(counts=1 + len(cbatches) + 3, ids=1 + len(ibatches) + 3)
    return servers, cbatches[0], ibatches[0], launches, calls


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


def kernel_phase(torch, servers, qc, qi, launches, calls):
    from repro_torch.kernels.range_probe import kernel, ops, ref
    from repro_torch.query import range as range_mod
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
        mask_out = "mask" in name
        li = "x" if skip else "off"
        tiles = lay[li].canon_tiles
        q = qi if mask_out else qc
        cand = routed(servers[li], q)
        if mask_out:        # the largest launch the ids executor makes
            rows, w = max(range_mod.hit_table_blocks(cand, cap),
                          key=lambda b: (b[0].stop - b[0].start) * b[1])
            q, cand = q[rows], cand[rows, :w].contiguous()
        qn, f = cand.shape
        kfn = getattr(kernel, name)
        plain = getattr(ref, name.replace("gather_", "gathered_")
                        .replace("count", "counts"))
        cases, worst = [], 0
        for alive_name, alive in (("staged", lay[li].alive),
                                  ("none", None), ("random", rand_alive)):
            for cb_name, cb in ((("bounding", lay["x"].chunk_boxes),
                                 ("non_bounding", bad)) if skip
                                else (("none", None),)):
                extra = (cb,) if skip else ()

                def k():
                    return kfn(q, tiles, *extra, cand, alive=alive)

                def r(qq, cc):
                    boxes = ((ops.gathered_chunk_boxes(cb, cc),) if skip
                             else ())
                    return plain(qq, ops.gathered_rows(tiles, cc), *boxes,
                                 None if alive is None
                                 else ops.gathered_alive(alive, cc))

                got = k()
                t_plain = time.perf_counter()
                want = plain_blocked(torch, r, q, cand, cap, mask_out)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t_plain) * 1e3
                if got.shape != want.shape:
                    raise AssertionError(f"{name}: shape {tuple(got.shape)}"
                                         f" != {tuple(want.shape)}")
                err = 0 if not got.numel() else int(
                    torch.ne(got, want).any() if mask_out
                    else (got - want).abs().max())
                if err != 0:
                    raise AssertionError(
                        f"{name} (alive={alive_name}, chunk boxes="
                        f"{cb_name}) differs from its plain version: "
                        f"max abs err {err}")
                worst = max(worst, err)
                ms = cuda_ms(torch, k, 10)
                cases.append(dict(alive=alive_name, chunk_boxes=cb_name,
                                  ms=ms, plain_ms=plain_ms))
        main = cases[0]      # the serving path's own inputs
        bytes_, pair_bytes, ops_ = bound_work(
            torch, ref, ops, q, cand, tiles, lay[li].alive,
            lay["x"].chunk_boxes if skip else None, mask_out)
        bound_ms = max(bytes_ / HBM_BYTES_PER_S, ops_ / FP32_OPS_PER_S) * 1e3
        entries.append(dict(
            name=name, route="cuda",
            source="port/repro_torch/kernels/range_probe/csrc/range_probe.cu",
            replaces=replaces, launches=launches[name], max_abs_err=worst,
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=bound_ms,
            bound_by=("bytes" if bytes_ / HBM_BYTES_PER_S
                      >= ops_ / FP32_OPS_PER_S else "operations"),
            library_ms=None, bit_equal=worst == 0,
            launches_per_batch=launches[name] / calls["ids" if mask_out
                                                      else "counts"],
            shape=dict(q=qn, f=f, t=t, cap=cap, c=c),
            bound_ms_per_pair=pair_bytes / HBM_BYTES_PER_S * 1e3,
            cases=cases))
    return entries


def bound_work(torch, ref, ops, q, cand, tiles, alive, cboxes, mask_out,
               rows=64):
    """Least bytes and operations of one call on these inputs.

    bytes: every (tile, chunk) that some live (query, candidate) pair
    must examine, read once (its alive flags, and its member boxes where
    alive), the chunk boxes of every referenced tile, the queries, the
    candidate list and the output.  Also returned: the reads counted
    per pair, Q*F*live_chunks*128*(16 + 1) plus the output, the bound
    of a design that shares no tile between queries.  operations: four
    float compares per alive slot of every live pair's live chunks.
    """
    t, cap = tiles.shape[:2]
    n_chunks = -(-cap // ops.CHUNK)
    touched = torch.zeros(t + 1, n_chunks, dtype=torch.bool, device=q.device)
    pair_chunks = 0
    for i in range(0, q.shape[0], rows):
        cc = cand[i:i + rows]
        idx = torch.where(cc >= 0, cc, t).long()
        if cboxes is None:
            live = (cc >= 0)[..., None].expand(-1, -1, n_chunks)
        else:
            live = ref.gathered_chunk_hits(
                q[i:i + rows], ops.gathered_chunk_boxes(cboxes, cc))
            live = live & (cc >= 0)[..., None]
        pair_chunks += int(live.sum())
        tt = idx[..., None].expand_as(live)[live]
        ch = torch.nonzero(live, as_tuple=True)[2]
        touched[tt, ch] = True
    touched = touched[:t]
    slot_alive = torch.cat([alive, alive.new_zeros(
        t, n_chunks * ops.CHUNK - cap)], dim=1)
    alive_per_chunk = slot_alive.reshape(t, n_chunks, ops.CHUNK).sum(2)
    n_touched = int(touched.sum())
    alive_touched = int(alive_per_chunk[touched].sum())
    ref_tiles = int(torch.unique(cand[cand >= 0]).numel())
    out_bytes = cand.numel() * (cap if mask_out else 4)
    bytes_ = (n_touched * ops.CHUNK + alive_touched * 16
              + (ref_tiles * n_chunks * 16 if cboxes is not None else 0)
              + q.numel() * 4 + cand.numel() * 4 + out_bytes)
    pair_bytes = pair_chunks * ops.CHUNK * 17 + out_bytes
    mean_alive = alive_touched / max(n_touched, 1)
    ops_ = 4 * pair_chunks * mean_alive
    return bytes_, pair_bytes, ops_


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; torch.cuda is not "
              "available", file=sys.stderr)
        return 2
    from repro_torch.kernels.range_probe import kernel

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    lib = kernel.build()
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    emit(dict(phase="build", seconds=time.perf_counter() - t0,
              library=lib.name, device=name, nvidia_smi=smi,
              torch=torch.__version__, cuda=torch.version.cuda,
              ptxas=ptxas))

    t0 = time.perf_counter()
    servers, qc, qi, launches, calls = serve_phase(torch, dev)
    t1 = time.perf_counter()
    entries = kernel_phase(torch, servers, qc, qi, launches, calls)
    for e in entries:
        emit(dict(phase="kernel", **e))
    emit(dict(phase="wall", serve_s=t1 - t0,
              kernels_s=time.perf_counter() - t1))
    emit({"kernels": [{k: e[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "bit_equal")}
        for e in entries]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
