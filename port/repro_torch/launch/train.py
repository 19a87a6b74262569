"""End-to-end training launcher (twin of ``repro.launch.train``).

Runs a real training loop (token pipeline -> train step -> checkpoint
and restart through the FT runtime) on the card, or on the CPU when
asked.

  python -m repro_torch.launch.train --arch mamba2_1p3b --smoke
  python -m repro_torch.launch.train --arch mamba2_1p3b --batch 8 \\
      --seq 2048 --steps 100                    # the published 1.3 B
  python -m repro_torch.launch.train --arch mamba2_1p3b --smoke \\
      --device cpu --steps 6 --inject-failure-at 3

Only the ssm family is ported: the dense presets, and the default
(``20m``), raise until ROADMAP Queue 1 item 14c.  Weights are random
from seed 0.  ``on_step(step, metrics)``, where a caller of ``main``
passes one, is called after every completed step with its metrics as
floats.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs
from .. import device as device_mod
from ..data import tokens as data_tokens
from ..device import not_ported
from ..ft.runtime import FTConfig, run_loop
from ..models import api
from ..optim.adamw import AdamWConfig

PRESETS = ("100m", "20m")   # the reference's dense presets


def main(argv=None, on_step=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default=None, choices=list(PRESETS))
    ap.add_argument("--arch", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config of --arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="runs/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.preset or not args.arch:
        raise not_ported(f"the dense preset {args.preset or '20m'!r}",
                         "Queue 1 item 14c")
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    dev = device_mod.resolve(args.device)

    model = api.build(cfg, dev)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup=args.steps // 10)
    state = api.init_train_state(model, torch.Generator(dev).manual_seed(0),
                                 opt)
    n_params = sum(p.numel() for p in state.params.parameters())
    print(f"arch={cfg.name} params={n_params:,} device={dev}")

    step_fn = api.make_train_step(model, opt)
    pipe = data_tokens.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch)

    losses = []
    t_start = time.time()

    def logged_step(st, batch_idx):
        st, metrics = step_fn(st, data_tokens.batch_for_step(pipe, batch_idx,
                                                             dev))
        metrics = {k: float(v) for k, v in metrics.items()}
        losses.append(metrics["loss"])
        i = len(losses)
        if i % args.log_every == 0 or i == 1:
            dt = (time.time() - t_start) / i
            print(f"step {i:5d}  loss {losses[-1]:.4f}  "
                  f"{dt * 1e3:.0f} ms/step")
        if on_step is not None:
            on_step(i, metrics)
        return st, metrics

    ft = FTConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    state, metrics, info = run_loop(
        logged_step, state, list(range(args.steps)), ft,
        inject_failure_at=args.inject_failure_at)
    print(f"done: steps={info['steps']} restarts={info['restarts']} "
          f"first_loss={losses[0]:.4f} last_loss={losses[-1]:.4f}")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not decrease")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
