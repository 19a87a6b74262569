"""Hillclimb driver: A/B variants of one dry-run cell (twin of
``repro.launch.hillclimb``).

Each named variant is a (hypothesis -> change) pair; the driver runs
the cell once a variant (``launch.dryrun.run_cell``) and records the
three roofline terms, so before/after deltas are counted, not guessed.

  python -m repro_torch.launch.hillclimb \\
      --arch qwen15_4b --shape train_4k --mesh single \\
      --variants baseline,micro4,micro4+fast,micro4+fast+bf16g
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import dryrun

VARIANTS = {
    "baseline": {},
    "micro2": dict(n_micro=2),
    "micro4": dict(n_micro=4),
    "micro8": dict(n_micro=8),
    "fast": dict(fast_attn=True),
    "bf16g": dict(bf16_weight_gather=True),
    "dots": dict(remat="dots"),
    "noremat": dict(remat="none"),
    "moelocal": dict(moe_local=True),
    "cachehd": dict(cache_shard="hd"),
}


def variant_kwargs(spec: str) -> dict:
    kw: dict = {}
    for part in spec.split("+"):
        if part not in VARIANTS:
            raise KeyError(f"unknown variant {part!r}")
        kw.update(VARIANTS[part])
    return kw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--variants", default="baseline")
    ap.add_argument("--out", default="runs/perf_log.jsonl")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = []
    with open(args.out, "a") as f:
        for spec in args.variants.split(","):
            kw = variant_kwargs(spec)
            rec = dryrun.run_cell(args.arch, args.shape,
                                  args.mesh == "multi", verbose=False, **kw)
            rec["variant"] = spec
            f.write(json.dumps(rec) + "\n")
            f.flush()
            rows.append(rec)
            if rec["status"] == "ok":
                print(f"{spec:>22}: t_comp={rec['t_compute_s']:.3f}s "
                      f"t_mem={rec['t_memory_s']:.3f}s "
                      f"t_coll={rec['t_collective_s']:.3f}s "
                      f"bound={rec['bottleneck']} "
                      f"roofline={rec['roofline_fraction']:.4f} "
                      f"peakHBM={rec['peak_memory_bytes'] / 1e9:.1f}G "
                      f"fits={rec['fits_hbm']}")
            else:
                print(f"{spec:>22}: {rec['status']} "
                      f"{rec.get('error', '')[:120]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
