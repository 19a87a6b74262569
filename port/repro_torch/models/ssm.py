"""Mamba2 (SSD) block (twin of ``repro.models.ssm``): prefill through
the chunked SSD on the CUDA intra-chunk kernel, decode through the O(1)
state recurrence.

Parameters follow the paper (arXiv:2405.21060): in_proj -> (z, x, B, C,
dt); causal depthwise conv on (x, B, C); SSD; gated RMSNorm; out_proj.
They are kept in float32 and cast to the activations' type where used,
as the reference does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.parallel import block_index, spec_axes
from ..kernels.ssd import ops as ssd_ops
from . import layers


def dims(cfg):
    din = cfg.ssm_expand * cfg.d_model
    h = din // cfg.ssm_head_dim
    return din, h, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state


Mixer = layers.Params      # one layer's SSM parameters, named as in repro


def init_params(gen: torch.Generator, cfg) -> Mixer:
    d = cfg.d_model
    din, h, _, g, s = dims(cfg)
    dev = gen.device
    return Mixer({
        "in_proj": layers.dense_init(gen, (d, 2 * din + 2 * g * s + h)),
        "conv_w": layers.dense_init(gen, (cfg.ssm_conv, din + 2 * g * s)),
        "a_log": torch.zeros(h, device=dev),          # A = -exp(a_log)
        "dt_bias": torch.zeros(h, device=dev),
        "d_skip": torch.ones(h, device=dev),
        "gnorm": torch.zeros(din, device=dev),
        "out_proj": layers.dense_init(gen, (din, d)),
    })


def _split(proj, cfg):
    din, h, _, g, s = dims(cfg)
    z = proj[..., :din]
    xbc = proj[..., din:din + din + 2 * g * s]
    dt = proj[..., -h:]
    return z, xbc, dt


def forward(x, p: Mixer, cfg, chunk: int = ssd_ops.CHUNK):
    """Prefill forward. x: (B, L, D) -> (B, L, D)."""
    b, l, _ = x.shape
    din, h, hp, g, s = dims(cfg)
    proj = x @ p.in_proj.to(x.dtype)
    z, xbc, dt = _split(proj, cfg)
    xbc = F.silu(layers.causal_dconv(xbc, p.conv_w.to(x.dtype)))
    xs = xbc[..., :din].reshape(b, l, h, hp)
    bmat = xbc[..., din:din + g * s].reshape(b, l, g, s)
    cmat = xbc[..., din + g * s:].reshape(b, l, g, s)
    # torch's softplus returns x above 20 where jax's logaddexp(x, 0)
    # adds exp(-x): a relative difference below 2.1e-9
    dt = F.softplus(dt.float() + p.dt_bias)
    a_log = -torch.exp(p.a_log)

    pad = (-l) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    y = ssd_ops.ssd_forward(xs.float().contiguous(), dt.contiguous(), a_log,
                            bmat.float().contiguous(),
                            cmat.float().contiguous(), chunk=chunk)
    y = y[:, :l] + xs[:, :l].float() * p.d_skip[None, None, :, None]
    y = y.reshape(b, l, din).to(x.dtype)
    y = y * F.silu(z)
    y = layers.rms_norm(y, p.gnorm, cfg.norm_eps)
    return y @ p.out_proj.to(x.dtype)


def init_cache(cfg, batch: int, dtype, device) -> dict:
    din, h, hp, g, s = dims(cfg)
    return {
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, din + 2 * g * s,
                            dtype=dtype, device=device),
        "state": torch.zeros(batch, h, s, hp, dtype=torch.float32,
                             device=device),
    }


def decode_step(x, cache: dict, p: Mixer, cfg, par=None, spec=None):
    """x: (B, 1, D) -> (y, cache); O(1) in sequence length.

    The reference donates its cache; here the state is updated in place
    (``cache["state"]`` is the same tensor afterwards) and the conv
    history is a new tensor.  B and C stay grouped: heads are viewed as
    (group, head of the group).  Under a mesh (``par``) whose cache
    ``spec`` splits the state's heads or the conv channels over mesh
    axes (``launch.cells.cache_specs``), the conv history is gathered,
    the projections and the conv run whole on every rank, each rank
    updates its heads' state (B and C taken a head) and keeps its
    channels of the new history, and the heads' outputs are gathered.
    """
    mesh = None if par is None else par.mesh
    c_ax = () if mesh is None else spec_axes(spec["conv"][-1])
    h_ax = () if mesh is None else spec_axes(spec["state"][1])
    b = x.shape[0]
    din, h, hp, g, s = dims(cfg)
    rep = h // g
    conv = cache["conv"]
    for a in reversed(c_ax):
        conv = mesh.all_gather(conv, axis=a, dim=-1)
    proj = x @ p.in_proj.to(x.dtype)
    z, xbc, dt = _split(proj, cfg)
    hist = torch.cat([conv, xbc], dim=1)
    xbc_c = F.silu(torch.einsum("bkc,kc->bc", hist, p.conv_w.to(x.dtype)))
    hi, nh = (0, 1) if mesh is None else block_index(mesh, h_ax)
    hl = h // nh
    heads = slice(hi * hl, (hi + 1) * hl)
    xs = xbc_c[..., :din].reshape(b, h, hp).float()
    bmat = xbc_c[..., din:din + g * s].reshape(b, g, s).float()
    cmat = xbc_c[..., din + g * s:].reshape(b, g, s).float()
    if nh == 1:
        gv, rv = g, rep
    else:
        grp = torch.arange(hi * hl, (hi + 1) * hl, device=x.device) // rep
        gv, rv, bmat, cmat = hl, 1, bmat[:, grp], cmat[:, grp]
    dtv = F.softplus(dt.float() + p.dt_bias)[:, 0, heads]     # (B, hl)
    a = torch.exp(dtv * (-torch.exp(p.a_log[heads])))         # (B, hl)
    state = cache["state"].view(b, gv, rv, s, hp)
    state.mul_(a.reshape(b, gv, rv, 1, 1))
    # state += (dt . B) (x) x, one rank-1 update a head
    state.addcmul_((dtv.reshape(b, gv, rv, 1) * bmat[:, :, None])[..., None],
                   xs[:, heads].reshape(b, gv, rv, 1, hp))
    # C . state as a broadcast matmul over the state's own layout (an
    # einsum would permute a copy of the whole state first)
    y = torch.matmul(cmat[:, :, None, None, :], state)[..., 0, :]
    y = y.reshape(b, hl, hp)
    for ax in reversed(h_ax):
        y = mesh.all_gather(y, axis=ax, dim=1)
    y = y + xs * p.d_skip[:, None]
    y = y.reshape(b, 1, din).to(x.dtype) * F.silu(z)
    y = layers.rms_norm(y, p.gnorm, cfg.norm_eps)
    new_conv = hist[:, 1:]
    if c_ax:
        ci, nc = block_index(mesh, c_ax)
        cl = hist.shape[-1] // nc
        new_conv = new_conv[..., ci * cl:(ci + 1) * cl].contiguous()
    return y @ p.out_proj.to(x.dtype), {"conv": new_conv,
                                        "state": cache["state"]}
