"""Batched greedy-decoding server loop (twin of
``repro.launch.serve``).

  python -m repro_torch.launch.serve --arch gemma2_27b --batch 8 \\
      --prompt-len 32 --gen 32            # smoke config, on cuda
  python -m repro_torch.launch.serve --no-smoke --batch 128   # published
  python -m repro_torch.launch.serve --arch whisper_medium --device cpu

The prompt is fed one token a step through the serve step (the O(1)
recurrence), as the reference does; ``--no-smoke`` runs the published
configuration (the reference's ``--smoke`` flag cannot be turned off).
Weights and prompt are random, from fixed seeds; the encoder-decoder
family gets seeded bf16 frames, as the reference's launcher does.

Under ``torch.distributed.run`` each rank serves its own replica of the
model on its device (``launch.mesh.from_env``, the backend named by
``--backend``); the ranks check that they decoded the same tokens and
only rank 0 prints.  Sharding a model over the ranks is not ported.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import configs
from .. import device as device_mod
from ..models import api, encdec
from . import mesh as mesh_lib


def generate(model: api.Model, params, prompt: torch.Tensor, gen: int,
             on_step=None, frames: torch.Tensor | None = None
             ) -> torch.Tensor:
    """Greedy decode: feed ``prompt`` (B, P) one token a step, then
    ``gen`` generated tokens -> (B, gen) int32.  ``frames`` (B, src_len,
    d_model): the encoder-decoder's input, whose encoding builds the
    cross-attention cache.  ``on_step(pos)`` is called after each
    step."""
    serve = api.make_serve_step(model)
    batch, prompt_len = prompt.shape
    max_len = prompt_len + gen
    if model.cfg.family == "encdec":
        with torch.no_grad():
            cache = encdec.init_cache(params, frames, model.cfg, max_len)
    else:
        cache = model.init_cache(batch, max_len)
    tok = prompt[:, 0]
    out = []
    for pos in range(max_len - 1):
        nxt, cache = serve(params, cache, tok, pos)
        tok = prompt[:, pos + 1] if pos + 1 < prompt_len else nxt
        if pos + 1 >= prompt_len:
            out.append(nxt)
        if on_step is not None:
            on_step(pos)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2_1p3b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                    help="the process group's backend under "
                    "torch.distributed.run (required there)")
    args = ap.parse_args(argv)

    mesh = None
    if mesh_lib.launched():
        if args.backend is None:
            ap.error("under torch.distributed.run, name --backend")
        mesh = mesh_lib.from_env(args.backend, args.device)
    try:
        return _run(args, mesh)
    finally:
        mesh_lib.close(mesh)


def _run(args, mesh) -> int:
    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    dev = device_mod.resolve(args.device) if mesh is None else mesh.device
    model = api.build(cfg, dev)
    params = model.init_params(torch.Generator(dev).manual_seed(0))
    frames = None
    if cfg.family == "encdec":
        frames = torch.randn((args.batch, cfg.src_len, cfg.d_model),
                             generator=torch.Generator(dev).manual_seed(1),
                             device=dev).to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator(dev).manual_seed(2),
                           device=dev)
    t0 = time.time()
    seqs = generate(model, params, prompt, args.gen, frames=frames)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    toks = seqs.numel()
    if mesh is not None:
        every = mesh.all_gather(seqs)
        if not all(torch.equal(every[r], seqs) for r in range(mesh.size)):
            raise RuntimeError("the ranks' replicas decoded different tokens")
        if mesh.rank:
            return 0
    print(f"arch={cfg.name} device={dev} generated {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s, batch={args.batch})"
          + ("" if mesh is None else f", each of {mesh.size} ranks"))
    print("sample:", seqs[0][:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
