"""``repro``'s parameter pytree, as numpy arrays, into the port's module.

``repro`` stacks each pattern position's parameters over a leading
super-block axis (``params["blocks"]["p0"][...][i]``) and keeps
remainder layers under ``params["rest"]``; the port keeps one module a
layer.  Every tensor keeps the name of its key in ``repro``'s pytree
(``blocks[i].ssm.in_proj`` is ``params["blocks"]["p0"]["ssm"]
["in_proj"][i]``), so both packages compute with the same weights.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from . import blocks, lm, ssm


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def _block(tree: dict, kind: str, dev) -> blocks.Block:
    blocks._only_ssm(kind)
    return blocks.Block(_t(tree["norm1"], dev), ssm.Mixer(
        {k: _t(v, dev) for k, v in tree["ssm"].items()}))


def params_from_numpy(tree: dict, cfg, device=None) -> lm.LM:
    """``tree``: repro's ``lm.init_params`` result with numpy leaves."""
    dev = device_mod.resolve(device)
    pat, n_super, rest = lm.structure(cfg)
    layers_ = []
    for i in range(n_super):
        for j, kind in enumerate(pat):
            stacked = tree["blocks"][f"p{j}"]
            layers_.append(_block(
                {"norm1": stacked["norm1"][i],
                 "ssm": {k: v[i] for k, v in stacked["ssm"].items()}},
                kind, dev))
    for i in range(rest):
        layers_.append(_block(tree["rest"][f"r{i}"], pat[i], dev))
    return lm.LM(_t(tree["embed"], dev), _t(tree["final_norm"], dev),
                 layers_, None if cfg.tie_embeddings
                 else _t(tree["unembed"], dev))
