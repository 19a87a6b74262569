"""Dry-run: every (arch x shape x mesh) cell's step run once on fake
tensors on one rank of a recording production mesh, and its roofline
terms (twin of ``repro.launch.dryrun``).

Usage, from ``port/``:
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh single --out runs/dryrun.jsonl

The reference lowers and compiles each cell for 512 placeholder host
devices; the port needs no device: ``launch.cells`` builds the rank's
state on fake tensors and runs its eager step once under the counters
(``launch.roofline.count``), and the ``RecordingMesh`` stands in for
the other ranks.  ``t_lower_s`` is that run's seconds and
``t_compile_s`` is 0.  With ``extrapolate`` (the default) the cell runs
at one and at two super-blocks of depth (the config's remainder layers
kept in both) and every count follows as ``a + b * n_super``: exact, as
the eager program repeats each super-block's work, and cheaper than the
full depth.  The peak live bytes follow the same rule only while the
step's peak falls at the same point of its last super-block; the tests
hold it to the full depth's on train steps with and without remat and
on batch-1 decode.  The reference needs the probes because XLA counts a loop
body once; the port counts every iteration, so its full-depth run
(``extrapolate=False``) gives the same numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import traceback

from torch._subclasses.fake_tensor import FakeTensorMode

from .. import configs
from ..models import api, lm
from . import cells, mesh as mesh_lib, roofline, shapes as shapes_lib


def _probe_cfg(cfg, k: int):
    """``cells.reduced_depth_cfg`` at ``k`` super-blocks, with the
    config's remainder layers kept, so a count is ``a + b * k``."""
    _, _, rest = lm.structure(cfg)
    red = cells.reduced_depth_cfg(cfg, k)
    return dataclasses.replace(red, n_layers=red.n_layers + rest)


def _run(arch, shape_name, mesh, remat, n_micro, cfg=None, **cellkw):
    cell = cells.build_cell(arch, shape_name, mesh, remat=remat,
                            cfg_override=cfg, n_micro=n_micro, **cellkw)
    if cell is None:
        return None, None
    return cell, cell.run_fn()


def _extrapolated(c1: roofline.Counts, c2: roofline.Counts,
                  n: int) -> roofline.Counts:
    """Counts at ``n`` super-blocks from those at 1 and 2."""
    def lin(a, b):
        return (2 * a - b) + (b - a) * n

    coll = {k: lin(v, c2.coll[k]) for k, v in c1.coll.items()
            if k != "ops"}
    kinds = set(c1.coll["ops"]) | set(c2.coll["ops"])
    coll["ops"] = {k: lin(c1.coll["ops"].get(k, 0), c2.coll["ops"].get(k, 0))
                   for k in sorted(kinds)}
    return roofline.Counts(
        flops=lin(c1.flops, c2.flops),
        hbm_bytes=lin(c1.hbm_bytes, c2.hbm_bytes), coll=coll,
        peak_memory=lin(c1.peak_memory, c2.peak_memory),
        seconds=c1.seconds + c2.seconds)


def cell_counts(arch: str, shape_name, mesh, remat: str = "full",
                extrapolate: bool = True, n_micro: int = 1,
                cfg_override=None, **cellkw):
    """(cell, counts) of one cell on ``mesh``: the full depth's counts,
    extrapolated from the depth-1 and depth-2 runs or run whole;
    (None, None) where the shape does not apply.  ``cfg_override``: the
    config in place of ``arch``'s."""
    cfg = cfg_override or configs.get(arch)
    if not extrapolate:
        return _run(arch, shape_name, mesh, remat, n_micro, cfg, **cellkw)
    cell, c1 = _run(arch, shape_name, mesh, remat, n_micro,
                    _probe_cfg(cfg, 1), **cellkw)
    if cell is None:
        return None, None
    _, c2 = _run(arch, shape_name, mesh, remat, n_micro,
                 _probe_cfg(cfg, 2), **cellkw)
    return (dataclasses.replace(cell, cfg=cfg),
            _extrapolated(c1, c2, lm.structure(cfg)[1]))


def decode_mem_floor(cfg, shape, chips: int) -> float:
    """bf16 weights and the whole KV/SSM cache read once a token,
    spread over the mesh."""
    cache = shapes_lib.abstract_cache(api.build(cfg, "cpu"), cfg, shape,
                                      FakeTensorMode())
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in cells.state_tensors(cache))
    return (2.0 * cfg.n_params() + cache_bytes) / chips


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             remat: str = "full", verbose: bool = True,
             extrapolate: bool = True, n_micro: int = 1, **cellkw) -> dict:
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    rec: dict = {"arch": arch, "shape": shape_name,
                 "mesh": "multi" if multi_pod else "single", "chips": chips,
                 "n_micro": n_micro, **{k: v for k, v in cellkw.items() if v}}
    cfg = configs.get(arch)
    shape = shapes_lib.SHAPES[shape_name]
    ok, why = shapes_lib.cell_supported(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["why"] = why
        return rec
    try:
        cell, c = cell_counts(arch, shape_name, mesh, remat, extrapolate,
                              n_micro, **cellkw)
        rl = roofline.analyze(c)
        tc, tm, tl = rl.t_compute, rl.t_memory, rl.t_collective
        mf = roofline.model_flops(cfg, shape, chips)
        if cell.kind == "decode":
            floor = decode_mem_floor(cfg, shape, chips)
            rec["decode_mem_floor_bytes"] = floor
            rec["decode_mem_fraction"] = round(floor / max(rl.hbm_bytes,
                                                           1.0), 4)
        rec.update(
            status="ok", kind=cell.kind,
            t_lower_s=round(c.seconds, 1), t_compile_s=0.0,
            flops_per_chip=rl.flops, hbm_bytes_per_chip=rl.hbm_bytes,
            coll_bytes_per_chip=rl.coll_bytes,
            coll_detail={k: v for k, v in rl.coll_detail.items() if v},
            t_compute_s=tc, t_memory_s=tm, t_collective_s=tl,
            bottleneck=rl.bottleneck,
            peak_memory_bytes=rl.peak_memory,
            model_flops_per_chip=mf,
            useful_flop_ratio=round(mf / max(rl.flops, 1.0), 4),
            roofline_fraction=round(mf / roofline.PEAK_FLOPS
                                    / max(tc, tm, tl, 1e-12), 4),
            fits_hbm=bool(rl.peak_memory <= roofline.HBM_BYTES),
        )
        if verbose:
            print(f"--- {arch} × {shape_name} × {rec['mesh']} ---")
            print({k: rec[k] for k in ("flops_per_chip",
                                       "hbm_bytes_per_chip",
                                       "coll_bytes_per_chip",
                                       "peak_memory_bytes", "bottleneck",
                                       "roofline_fraction")})
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"[:500]
        rec["trace"] = traceback.format_exc()[-2000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(shapes_lib.SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--bf16-gather", action="store_true")
    ap.add_argument("--fast-attn", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    archs = configs.ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(shapes_lib.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    out_f = open(args.out, "a") if args.out else None
    n_fail = 0
    try:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    rec = run_cell(arch, shape, mp, remat=args.remat,
                                   verbose=not args.quiet,
                                   n_micro=args.micro,
                                   bf16_weight_gather=args.bf16_gather,
                                   fast_attn=args.fast_attn)
                    line = json.dumps(rec)
                    print(line if args.quiet else
                          f"[{rec['status']}] {arch} {shape} {rec['mesh']}",
                          flush=True)
                    if out_f:
                        out_f.write(line + "\n")
                        out_f.flush()
                    if rec["status"] == "fail":
                        n_fail += 1
                        print(rec["error"], file=sys.stderr)
    finally:
        if out_f:
            out_f.close()
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
