"""The paper's partitioning + spatial join as one command (twin of
``repro.launch.partition_etl``): partition a generated dataset, print
the paper's layout metrics, and optionally run a self-join.

    cd port && python -m repro_torch.launch.partition_etl \\
        --dataset osm --n 20000 --method bos --payload 500 --join

It runs on one card, or on the CPU only when given ``--device cpu``.
``--parallel`` partitions with the MapReduce-style partitioner
(``query.parallel_partition``) over as many buckets as there are
devices (the CUDA device count; 1 on the CPU), simulated on the one
device, and the join plans for that many devices, as the reference's
``jax.device_count()`` does.

Under ``torch.distributed.run`` each rank is one device of a process
mesh (``launch.mesh.from_env``, with the backend named by
``--backend``): the parallel partition and the join run over the ranks
and only rank 0 prints.  On the CPU, four ranks over gloo:

    cd port && python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.partition_etl --backend gloo --device cpu \
        --n 20000 --method bsp --parallel --join
"""
from __future__ import annotations

import argparse
import time

import torch

from ..core import metrics
from ..core.partition import api as papi, partition_counts
from ..data import spatial_gen
from ..device import resolve
from ..query import engine, parallel_partition
from . import mesh as mesh_lib


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="osm", choices=["osm", "pi"])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--method", default="bos", choices=list(papi.methods()))
    ap.add_argument("--payload", type=int, default=500)
    ap.add_argument("--parallel", action="store_true",
                    help="use the MapReduce-style distributed partitioner")
    ap.add_argument("--join", action="store_true", help="run a self-join")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain kernel versions)")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="the process group's backend under "
                    "torch.distributed.run (required there)")
    args = ap.parse_args(argv)

    mesh = None
    if mesh_lib.launched():
        if args.backend is None:
            ap.error("under torch.distributed.run, name --backend")
        mesh = mesh_lib.from_env(args.backend, args.device)
        dev = mesh.device
        n_dev = mesh.size
    else:
        dev = resolve(args.device)
        n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    try:
        return _run(args, dev, n_dev, mesh, say)
    finally:
        mesh_lib.close(mesh)


def _run(args, dev, n_dev, mesh, say) -> int:
    mbrs = spatial_gen.dataset(args.dataset, args.n, seed=0, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    if args.parallel:
        parts, stats = parallel_partition.parallel_partition(
            mbrs, args.payload, n_dev, mesh)
        say(f"parallel partition stats: {stats}")
    else:
        parts = papi.partition(args.method, mbrs, args.payload)
    _sync(dev)
    t_part = time.perf_counter() - t0

    counts, copies = partition_counts(mbrs, parts)
    say(f"method={args.method} n={args.n} payload={args.payload} "
        f"k={parts.k()} time={t_part * 1e3:.1f}ms device={dev}"
        + ("" if mesh is None else f" ranks={mesh.size}"))
    say(f"  λ(boundary ratio) = "
        f"{float(metrics.boundary_ratio(counts, parts.valid, args.n)):.4f}")
    say(f"  balance stddev    = "
        f"{float(metrics.balance_stddev(counts, parts.valid)):.2f}")
    say(f"  skew (max/mean)   = "
        f"{float(metrics.skew_ratio(counts, parts.valid)):.2f}")
    say(f"  coverage          = {float(metrics.coverage(copies)):.4f}")

    if args.join:
        s = spatial_gen.dataset(args.dataset, args.n, seed=7, device=dev)
        t0 = time.perf_counter()
        plan = engine.plan_join(args.method, mbrs, s, args.payload, n_dev,
                                device=dev)
        cnt = engine.spatial_join_count(plan, mesh)
        dt = time.perf_counter() - t0
        say(f"  join: |R⋈S| = {cnt}  ({dt:.2f}s incl. planning; "
            f"tile skew {plan.stats['skew']:.2f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
