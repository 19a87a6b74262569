"""Assigned input shapes and abstract inputs, allocating nothing (twin
of ``repro.launch.shapes``).

Four shapes per architecture:
  train_4k     seq 4096,   global_batch 256  -> train step
  prefill_32k  seq 32768,  global_batch 32   -> prefill step
  decode_32k   seq 32768 (KV cache), gb 128  -> serve step
  long_500k    seq 524288 (KV cache), gb 1   -> serve step (sub-quadratic
               archs only)

The reference's ``jax.eval_shape`` is torch's ``FakeTensorMode`` here:
the port's own CPU code runs on fake tensors, which carry shapes and
types and hold no memory.  Every function below takes the fake mode to
make its tensors in (``mode``) and returns fake tensors of the
reference's shapes and types.
"""
from __future__ import annotations

import dataclasses

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..models import api, encdec, lm
from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k policy: sub-quadratic attention only
LONG_OK = {"gemma2-27b", "mixtral-8x22b", "recurrentgemma-9b", "mamba2-1.3b"}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_OK:
        return False, "pure full-attention arch: long_500k skipped"
    return True, ""


def batch_specs(cfg: ModelConfig, shape: ShapeSpec,
                mode: FakeTensorMode) -> dict:
    """The (train or prefill) global batch as fake tensors: tokens int32,
    the vlm's image patches and the encoder's frames bf16."""
    b, s = shape.global_batch, shape.seq_len
    with mode:
        specs = {"tokens": torch.empty((b, s), dtype=torch.int32)}
        if cfg.family == "vlm":
            specs["img"] = torch.empty((b, cfg.vis_tokens, cfg.vis_dim),
                                       dtype=torch.bfloat16)
        if cfg.family == "encdec":
            specs["frames"] = torch.empty((b, cfg.src_len, cfg.d_model),
                                          dtype=torch.bfloat16)
    return specs


def abstract_params(model: api.Model, mode: FakeTensorMode):
    """The model's whole parameters (``lm.LM`` or ``encdec.EncDec``) as
    fake tensors."""
    with mode:
        return model.init_params(torch.Generator())


def abstract_cache(model: api.Model, cfg: ModelConfig, shape: ShapeSpec,
                   mode: FakeTensorMode, params=None):
    """The whole decode cache as fake tensors: ``lm.init_cache``'s list
    of per-layer dicts, or for the encoder-decoder ``encdec.init_cache``
    of fake frames (the encoder runs on them, as the reference's
    ``eval_shape`` traces ``encode()``); ``params``: the whole fake
    parameters, made here when not given."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family == "encdec":
        params = abstract_params(model, mode) if params is None else params
        frames = batch_specs(cfg, shape, mode)["frames"]
        with mode, torch.no_grad():
            return encdec.init_cache(params, frames, cfg, s)
    with mode:
        return lm.init_cache(cfg, b, s, torch.device("cpu"))
