"""Render dry-run JSONL records into roofline tables (twin of
``repro.launch.report``).

  python -m repro_torch.launch.report runs/dryrun.jsonl      # from port/
"""
from __future__ import annotations

import json
import sys


def fmt_bytes(b):
    return f"{b / 1e9:.2f}G" if b >= 1e8 else f"{b / 1e6:.1f}M"


def fmt_t(s):
    if s <= 0:
        return "0"
    return f"{s * 1e3:.2f}ms" if s < 1 else f"{s:.2f}s"


def load(path):
    """The records of a dry-run's JSONL file, the last of each (arch,
    shape, mesh)."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    dedup = {}
    for r in recs:
        dedup[(r["arch"], r["shape"], r["mesh"])] = r
    return list(dedup.values())


def roofline_table(recs, mesh="single"):
    rows = [r for r in recs if r["mesh"] == mesh]
    out = ["| arch | shape | kind | t_comp | t_mem | t_coll | bound | "
           "useful | roofline | HBM/chip | fits |",
           "|---|---|---|---|---|---|---|---|---|---|---|"[:-4]]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                       f"| — | — | — | skipped |")
            continue
        if r["status"] == "fail":
            out.append(f"| {r['arch']} | {r['shape']} | FAIL | "
                       f"{r.get('error', '')[:40]} | | | | | | | |")
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['kind']} | "
            f"{fmt_t(r['t_compute_s'])} | {fmt_t(r['t_memory_s'])} | "
            f"{fmt_t(r['t_collective_s'])} | {r['bottleneck'][:4]} | "
            f"{r['useful_flop_ratio']:.2f} | {r['roofline_fraction']:.3f} | "
            f"{fmt_bytes(r['peak_memory_bytes'])} | "
            f"{'y' if r['fits_hbm'] else 'NO'} |")
    return "\n".join(out)


def summary(recs):
    ok = [r for r in recs if r["status"] == "ok"]
    skip = [r for r in recs if r["status"] == "skipped"]
    fail = [r for r in recs if r["status"] == "fail"]
    lines = [f"cells: {len(ok)} ok, {len(skip)} skipped (documented), "
             f"{len(fail)} failed"]
    for r in fail:
        lines.append(f"  FAIL {r['arch']} {r['shape']} {r['mesh']}: "
                     f"{r.get('error', '')[:120]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    recs = load(argv[0] if argv else "runs/dryrun_baseline.jsonl")
    print(summary(recs))
    print("\n## single mesh (16×16 = 256 ranks)\n")
    print(roofline_table(recs, "single"))
    print("\n## multi mesh (2×16×16 = 512 ranks)\n")
    print(roofline_table(recs, "multi"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
