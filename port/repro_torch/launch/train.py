"""End-to-end training launcher (twin of ``repro.launch.train``).

Runs a real training loop (token pipeline -> train step -> checkpoint
and restart through the FT runtime) on the card, or on the CPU when
asked, for every family and the reference's two dense presets.

  python -m repro_torch.launch.train                # the 20m preset
  python -m repro_torch.launch.train --preset 100m --steps 200
  python -m repro_torch.launch.train --arch gemma2_27b --smoke
  python -m repro_torch.launch.train --arch mamba2_1p3b --batch 8 \\
      --seq 2048 --steps 100                    # the published 1.3 B
  python -m repro_torch.launch.train --arch whisper_medium --smoke \\
      --device cpu --steps 6 --inject-failure-at 3

Weights are random from seed 0.  A vlm's batch carries zero image
tokens, as the reference's.  An encoder-decoder's frames are standard
normal, in bf16, drawn on the CPU (as the tokens are, so they do not
depend on the device) by a ``torch.Generator`` seeded with the step
index: the reference draws them from ``jax.random.PRNGKey(step)``,
whose bits cannot be reproduced here, so the frames are the port's own
(a restart regenerates a step's frames exactly).  ``on_step(step,
metrics)``, where a caller of ``main`` passes one, is called after
every completed step with its metrics as floats.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs
from .. import device as device_mod
from ..data import tokens as data_tokens
from ..ft.runtime import FTConfig, run_loop
from ..models import api
from ..models.config import ModelConfig
from ..optim.adamw import AdamWConfig

PRESETS = {
    # ~110M params: the end-to-end example scale
    "100m": ModelConfig(name="repro-100m", family="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv=4, d_ff=2048,
                        vocab=32768, head_dim=64),
    # ~20M params: fast CPU quickstart
    "20m": ModelConfig(name="repro-20m", family="dense", n_layers=8,
                       d_model=384, n_heads=6, n_kv=2, d_ff=1024,
                       vocab=8192, head_dim=64),
}


def config_of(preset: str | None, arch: str | None,
              smoke: bool) -> ModelConfig:
    """The run's configuration: a preset, else ``arch`` (its smoke
    config with ``smoke``), else the ``20m`` preset."""
    if preset:
        return PRESETS[preset]
    if arch:
        return configs.smoke(arch) if smoke else configs.get(arch)
    return PRESETS["20m"]


def make_batch(pipe: data_tokens.TokenPipelineConfig, cfg: ModelConfig,
               step: int, device) -> dict:
    """Step ``step``'s tokens, with a vlm's zero image tokens or an
    encoder-decoder's frames (see the module docstring)."""
    batch = data_tokens.batch_for_step(pipe, step, device)
    b = pipe.global_batch // pipe.n_hosts
    if cfg.family == "vlm":
        batch["img"] = torch.zeros((b, cfg.vis_tokens, cfg.vis_dim),
                                   dtype=torch.bfloat16, device=device)
    if cfg.family == "encdec":
        gen = torch.Generator().manual_seed(step)
        batch["frames"] = torch.randn(
            (b, cfg.src_len, cfg.d_model), generator=gen).to(
                device=device, dtype=torch.bfloat16)
    return batch


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

    cfg = config_of(args.preset, args.arch, args.smoke)
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
        st, metrics = step_fn(st, make_batch(pipe, cfg, batch_idx, dev))
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
