"""``repro``'s parameter pytree, as numpy arrays, into the port's module,
and back; and ``repro``'s train state into the port's.

``repro`` stacks each pattern position's parameters over a leading
super-block axis (``params["blocks"]["p0"][...][i]``) and keeps
remainder layers under ``params["rest"]``; the encoder-decoder stacks
``enc`` and ``dec`` over their layers.  The port keeps one module a
layer.  Every tensor keeps the name of its key in ``repro``'s pytree
(``blocks[i].ssm.in_proj`` is ``params["blocks"]["p0"]["ssm"]
["in_proj"][i]``), so both packages compute with the same weights.  ``tree_to_numpy``
stacks the layers back (parameters, or an ``OptState``'s ``m`` and
``v``, keyed by the parameters' names), so a state after a step is
compared leaf by leaf; bf16 moments come back as float32 arrays of the
same values (numpy has no bf16).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from ..optim import adamw
from . import api, blocks, encdec, layers, lm


def _t(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a stacked subtree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def _block(tree: dict, dev) -> blocks.Block:
    """One layer's subtree -> a Block: leaves are its norms, subtrees its
    parts."""
    parts = {k: layers.Params({n: _t(a, dev) for n, a in v.items()})
             for k, v in tree.items() if isinstance(v, dict)}
    return blocks.Block({k: _t(v, dev) for k, v in tree.items()
                         if not isinstance(v, dict)}, parts)


def params_from_numpy(tree: dict, cfg, device=None):
    """``tree``: repro's ``lm.init_params`` (or ``encdec.init_params``)
    result with numpy leaves -> ``lm.LM`` (or ``encdec.EncDec``)."""
    dev = device_mod.resolve(device)
    if cfg.family == "encdec":
        return encdec.EncDec(
            _t(tree["embed"], dev),
            [_block(_layer(tree["enc"], i), dev)
             for i in range(cfg.enc_layers)],
            [_block(_layer(tree["dec"], i), dev)
             for i in range(cfg.n_layers)],
            _t(tree["enc_norm"], dev), _t(tree["final_norm"], dev))
    pat, n_super, rest = lm.structure(cfg)
    layers_ = [_block(_layer(tree["blocks"][f"p{j}"], i), dev)
               for i in range(n_super) for j in range(len(pat))]
    layers_ += [_block(tree["rest"][f"r{i}"], dev) for i in range(rest)]
    return lm.LM(_t(tree["embed"], dev), _t(tree["final_norm"], dev),
                 layers_,
                 None if cfg.tie_embeddings else _t(tree["unembed"], dev),
                 _t(tree["vis_proj"], dev) if "vis_proj" in tree else None)


def tree_to_numpy(named: dict, cfg) -> dict:
    """Name -> tensor of the port's model (parameters or moments) ->
    ``repro``'s nested pytree of numpy arrays, block leaves stacked over
    the super-block axis."""
    tree: dict = {}
    stacks: dict = {}
    for name, t in named.items():
        path, layer = lm.ref_path(name, cfg)
        a = t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
            else t.detach().cpu().numpy()
        if layer is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = a
        else:
            stacks.setdefault(path, {})[layer] = a
    for path, layers_ in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([layers_[i] for i in range(len(layers_))])
    return tree


def params_to_numpy(params, cfg) -> dict:
    """The inverse of ``params_from_numpy``."""
    return tree_to_numpy(dict(params.named_parameters()), cfg)


def _leaves_like(tree: dict, params: lm.LM, cfg, dtype, dev) -> dict:
    """repro's pytree ``tree`` (numpy leaves) -> name -> tensor for each
    of ``params``' names, in ``dtype``."""
    out = {}
    for name in lm.named_leaves(params, cfg):
        path, layer = lm.ref_path(name, cfg)
        a = tree
        for key in path:
            a = a[key]
        a = np.array(a if layer is None else a[layer], dtype=np.float32)
        out[name] = torch.from_numpy(a).to(dev, dtype)
    return out


def train_state_from_numpy(state, cfg, opt_cfg: adamw.AdamWConfig,
                           device=None) -> api.TrainState:
    """``repro``'s ``TrainState`` with numpy leaves (``params``,
    ``opt.m``, ``opt.v``, ``opt.step``, ``step``) -> the port's, the
    parameters requiring grad and the moments in ``opt_cfg``'s types."""
    dev = device_mod.resolve(device)
    params = params_from_numpy(state.params, cfg, dev).requires_grad_(True)
    pol = opt_cfg.state_policy
    opt = adamw.OptState(
        m=_leaves_like(state.opt.m, params, cfg, adamw._m_dtype(pol), dev),
        v=_leaves_like(state.opt.v, params, cfg, adamw._v_dtype(pol), dev),
        step=torch.tensor(int(state.opt.step), dtype=torch.int32,
                          device=dev))
    return api.TrainState(params=params, opt=opt, step=torch.tensor(
        int(state.step), dtype=torch.int32, device=dev))
