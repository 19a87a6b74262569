"""repro_torch's training of every family but ssm against repro's, at the
smoke config (``configs.smoke``) of the nine archs: dense (gemma2's
local and global layers, softcaps, post-norms and tied embeddings;
stablelm; qwen1.5's QKV bias; command-r), MoE (mixtral; arctic's dense
residual), hybrid (recurrentgemma's RG-LRU and local attention), vlm
(internvl2's image prefix) and the encoder-decoder (whisper).  repro's
``init_params(PRNGKey(0))`` (or its train state) is carried across by
``convert``; tokens, images and frames are drawn with numpy.  repro's
loss, gradients and train step run under ``jax.jit``.

Tolerances, each measured on these inputs:

* float32 loss within 1e-5 relative (measured at most 3.1e-7), each
  gradient leaf within 1e-5 of its largest |g| (measured at most
  1.4e-6): float32 sums run in another order in torch than in XLA, the
  tolerance Mamba2's training is held to (``tests/test_torch_train.py``).
* bf16 loss within 1e-3 relative (measured at most 2.2e-5): both sides
  round to bf16, not at the same places.
* A train step: loss and ``grad_norm`` within 1e-5 relative, ``lr``
  within 1e-6 and the parameters within ``2 * lr`` a step
  (``tests/test_torch_train.py``'s reasons); the MoE payload metrics
  exactly (integer counts); bf16 weight gather: ``grad_norm`` within
  1e-3.
* Past the reference's windowed-attention NaN (L = 600 at window 32,
  NaN from 543 on): the port's float32 gradients are finite and within
  1e-5 of each leaf's largest |g| of its own float64 run (measured at
  most 3.3e-6);
  ``chunked_attention``'s input gradients within 1e-5 of a float64
  dense masked softmax's.
* ``remat`` "none", "full" and "dots": bit-equal gradients.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.models import api, convert, layers, lm, moe, rglru
from repro_torch.optim import adamw

torch.set_num_threads(1)
ARCHS = ["gemma2_27b", "stablelm_12b", "qwen15_4b", "command_r_35b",
         "whisper_medium", "mixtral_8x22b", "arctic_480b", "internvl2_26b",
         "recurrentgemma_9b"]
STEP_ARCHS = ["qwen15_4b", "gemma2_27b", "mixtral_8x22b",
              "recurrentgemma_9b", "internvl2_26b", "whisper_medium"]
WINDOWED = ["gemma2_27b", "mixtral_8x22b", "recurrentgemma_9b"]


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jconfigs.smoke(arch), dtype=dtype),
            dataclasses.replace(configs.smoke(arch), dtype=dtype))


def _batch(cfg, b, s, seed):
    """numpy tokens and the family's image tokens or frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["img"] = rng.standard_normal(
            (b, cfg.vis_tokens, cfg.vis_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.src_len, cfg.d_model)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(a))


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return japi.build(jconfigs.smoke(arch)).init_params(
        jax.random.PRNGKey(0))


def _pair(arch, dtype="float32"):
    cfg, tcfg = _cfgs(arch, dtype)
    p = _jparams(arch)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), tcfg,
                                   "cpu").requires_grad_(True)
    return cfg, tcfg, p, tp


def _grads(tp, tcfg, batch, remat="full"):
    model = api.build(tcfg, "cpu")
    loss, aux = model.loss_fn(tp, _t(batch), remat)
    named = lm.named_leaves(tp, tcfg)
    return loss, aux, dict(zip(named, torch.autograd.grad(
        loss, list(named.values()))))


def _close_leaves(got: dict, want, tol, tcfg):
    """Each leaf of repro's gradient tree ``want`` against the port's
    name -> tensor ``got`` stacked back: max |diff| <= tol * max |want|
    -> the largest ratio."""
    tree = convert.tree_to_numpy(got, tcfg)
    worst = 0.0
    wl = jax.tree_util.tree_leaves_with_path(want)
    gl = jax.tree.leaves(tree)
    assert len(wl) == len(gl)
    for (path, w), h in zip(wl, gl):
        w = np.asarray(w)
        assert h.shape == w.shape, path
        scale = np.abs(w).max()
        err = np.abs(h - w).max()
        assert err <= tol * scale, (jax.tree_util.keystr(path), err, scale)
        worst = max(worst, err / scale if scale else 0.0)
    return worst


# ------------------------- parameter bookkeeping -------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_order_and_dims_follow_repro(arch):
    """``named_leaves`` walks ``jax.tree.leaves``' order of repro's
    pytree (layers of a stacked leaf in turn), and ``ref_ndims`` gives
    each name its leaf's dimensions there: the MoE ``(n_stack, E, D,
    F)`` leaves, ``vis_proj``, the ``rest`` layers, tied embeddings and
    the encoder-decoder's stacks.  These decide the decayed and the
    bf16-cast leaves."""
    cfg, tcfg = _cfgs(arch)
    params = api.build(tcfg, "cpu").init_params(
        torch.Generator().manual_seed(0))
    named = lm.named_leaves(params, tcfg)
    shapes = jax.eval_shape(japi.build(cfg).init_params,
                            jax.random.PRNGKey(0))
    order = [tuple(str(getattr(q, "key", q)) for q in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(shapes)]
    assert list(dict.fromkeys(lm.ref_path(k, tcfg)[0] for k in named)) \
        == order
    nd = lm.ref_ndims(named, tcfg)
    for k in named:
        path, layer = lm.ref_path(k, tcfg)
        leaf = shapes
        for key in path:
            leaf = leaf[key]
        assert leaf.ndim == nd[k], k
        want = leaf.shape if layer is None else leaf.shape[1:]
        assert tuple(named[k].shape) == want, k
    if tcfg.family == "moe":
        assert nd["blocks.0.moe.w1"] == 4
    if tcfg.block_pattern:      # a rest layer's norm is not stacked
        assert nd[f"blocks.{tcfg.n_layers - 1}.norm1"] == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_converts_both_ways(arch):
    """repro's train state (random moments, step 3) comes across with
    ``train_state_from_numpy`` and goes back with ``tree_to_numpy``
    equal leaf for leaf."""
    _, tcfg = _cfgs(arch)
    params = _jparams(arch)
    rng = np.random.default_rng(5)

    def moments():
        return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)

    jstate = japi.TrainState(params=params, opt=jadamw.OptState(
        m=moments(), v=moments(), step=jnp.int32(3)), step=jnp.int32(3))
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, adamw.AdamWConfig(), "cpu")
    assert all(p.requires_grad for p in state.params.parameters())
    assert int(state.step) == 3 == int(state.opt.step)
    for got, want in (
            (convert.params_to_numpy(state.params, tcfg), jstate.params),
            (convert.tree_to_numpy(state.opt.m, tcfg), jstate.opt.m),
            (convert.tree_to_numpy(state.opt.v, tcfg), jstate.opt.v)):
        assert (jax.tree_util.tree_structure(got)
                == jax.tree_util.tree_structure(want))
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))


# --------------------------------- loss ----------------------------------

def _jstate0(arch):
    """repro's ``init_train_state`` of the smoke config (its parameters
    drawn once)."""
    params = _jparams(arch)
    return japi.TrainState(params=params,
                           opt=jadamw.init_state(params,
                                                 jadamw.AdamWConfig()),
                           step=jnp.zeros((), jnp.int32))


@functools.lru_cache(maxsize=None)
def _jvg(arch):
    cfg, _ = _cfgs(arch)
    model = japi.build(cfg)
    return jax.jit(jax.value_and_grad(
        lambda pp, b: model.loss_fn(pp, b, "full"), has_aux=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_repro_float32(arch):
    cfg, tcfg, p, tp = _pair(arch)
    batch = _batch(cfg, 2, 24, 1)
    (jl, jaux), jg = _jvg(arch)(p, _j(batch))
    loss, aux, grads = _grads(tp, tcfg, batch)
    assert loss.dtype == torch.float32 and _rel(jl, loss.detach()) < 1e-5
    assert sorted(aux) == sorted(jaux)
    _close_leaves(grads, jg, 1e-5, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_repro_bf16(arch):
    cfg, tcfg, p, tp = _pair(arch, "bfloat16")
    batch = _batch(cfg, 2, 24, 2)
    model = japi.build(cfg)
    jl, _ = jax.jit(lambda pp, b: model.loss_fn(pp, b))(p, _j(batch))
    with torch.no_grad():
        loss, _ = api.build(tcfg, "cpu").loss_fn(tp, _t(batch))
    assert loss.dtype == torch.float32 and _rel(jl, loss) < 1e-3


def test_vlm_prefix_carries_no_labels():
    """The image prefix's logits take no part in the loss: changing the
    image changes the loss only through the text positions (their
    attention to the prefix), and the loss's text slice is the last S
    positions."""
    _, tcfg, _, tp = _pair("internvl2_26b")
    b = _t(_batch(tcfg, 2, 12, 3))
    with torch.no_grad():
        logits, _ = lm.forward(tp, b["tokens"], tcfg, img=b["img"])
        assert logits.shape[1] == tcfg.vis_tokens + 12
        loss, _ = lm.loss_fn(tp, b, tcfg)
        assert torch.equal(loss, lm.nll(logits[:, tcfg.vis_tokens:],
                                        b["tokens"]))


# ------------------------------ train step -------------------------------

def _steps(arch, kw, n=3, b=4, s=16):
    cfg, tcfg = _cfgs(arch)
    model, opt = api.build(tcfg, "cpu"), adamw.AdamWConfig()
    jstate = _jstate0(arch)
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, opt, "cpu")
    jstep = jax.jit(japi.make_train_step(japi.build(cfg),
                                         jadamw.AdamWConfig(), **kw))
    step = api.make_train_step(model, opt, **kw)
    gn_tol = 1e-3 if kw.get("bf16_weight_gather") else 1e-5
    moved = 0.0
    for i in range(n):
        batch = _batch(cfg, b, s, 10 + i)
        jstate, jm = jstep(jstate, _j(batch))
        state, m = step(state, _t(batch))
        assert sorted(m) == sorted(jm)
        assert _rel(jm["loss"], m["loss"]) < 1e-5
        assert _rel(jm["grad_norm"], m["grad_norm"]) < gn_tol
        assert _rel(jm["lr"], m["lr"]) < 1e-6
        for k in m:
            if "skew" in k or "drop" in k:
                assert float(m[k]) == float(jm[k]), (k, m[k], jm[k])
        moved += 2 * float(jm["lr"])
        assert int(state.step) == i + 1 and int(state.opt.step) == i + 1
        want = jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))
        got = jax.tree.leaves(convert.params_to_numpy(state.params, tcfg))
        for a, c in zip(want, got):
            assert np.abs(a - c).max() <= moved + 1e-7
    return m


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_match_repro(arch):
    m = _steps(arch, {})
    if arch == "mixtral_8x22b":
        assert {"moe0_expert_skew", "moe0_drop_frac"} <= set(m)


@pytest.mark.parametrize("kw", [{"n_micro": 2},
                                {"bf16_weight_gather": True}],
                         ids=["n_micro2", "bf16_gather"])
@pytest.mark.parametrize("arch", ["qwen15_4b", "mixtral_8x22b"])
def test_train_step_options_match_repro(arch, kw):
    m = _steps(arch, kw, n=2)
    if "n_micro" in kw:     # the reference reports no aux then
        assert sorted(m) == ["grad_norm", "loss", "lr"]


# ------------------------ windowed and scan gradients --------------------

def _dense64(q, k, v, window):
    """float64 causal, windowed masked softmax over all keys at once."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    qp = torch.arange(q.shape[1])[:, None]
    kp = torch.arange(k.shape[1])[None, :]
    s = torch.where((qp >= kp) & (qp - kp < window), s, -torch.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)


@pytest.mark.parametrize("window", [32, 100])
def test_chunked_attention_gradient_matches_float64_dense(window):
    """L = 600, past the reference's NaN threshold window + 511 for
    window 32: every input gradient is finite and within 1e-5 of its
    largest of a float64 dense masked softmax's."""
    rng = np.random.default_rng(window)
    q, k, v = (rng.standard_normal((1, 600, h, 16)).astype(np.float32)
               for h in (4, 2, 2))
    gy = rng.standard_normal((1, 600, 4, 16))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = layers.chunked_attention(*ins, causal=True, window=window)
    got = torch.autograd.grad(out, ins, torch.from_numpy(gy).float())
    ins64 = [torch.from_numpy(a).double().requires_grad_(True)
             for a in (q, k, v)]
    want = torch.autograd.grad(_dense64(*ins64, window), ins64,
                               torch.from_numpy(gy))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert float((g.double() - w).abs().max()) <= 1e-5 * float(
            w.abs().max())


@pytest.mark.parametrize("arch", WINDOWED)
def test_windowed_gradients_past_the_reference_nan(arch):
    """At 600 tokens the reference's forward is NaN
    (``tests/test_torch_attention.py``); the port's float32 gradients
    are finite and equal its own float64 run's within 1e-5 of each
    leaf's largest."""
    _, tcfg, _, tp = _pair(arch)
    batch = _batch(tcfg, 1, 600, 4)
    loss, _, grads = _grads(tp, tcfg, batch)
    tcfg64 = dataclasses.replace(tcfg, dtype="float64")
    tp64 = copy.deepcopy(tp).double()
    loss64, _, grads64 = _grads(tp64, tcfg64, batch)
    assert loss64.dtype == torch.float64
    loss, loss64 = float(loss.detach()), float(loss64.detach())
    assert abs(loss - loss64) <= 1e-5 * abs(loss64)
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), k
        w = grads64[k]
        assert float((g.double() - w).abs().max()) <= 1e-5 * float(
            w.abs().max()), k


def test_rglru_scan_gradient_matches_repro():
    """The doubling scan's gradient against ``jax.grad`` through the
    reference's ``lax.associative_scan``, float32, a = the gates'
    range (0.9, 1)."""
    rng = np.random.default_rng(7)
    a = rng.uniform(0.9, 0.999, (2, 300, 8)).astype(np.float32)
    b = rng.standard_normal((2, 300, 8)).astype(np.float32)
    w = rng.standard_normal((2, 300, 8)).astype(np.float32)

    def jloss(a_, b_):
        _, h = jax.lax.associative_scan(
            lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]), (a_, b_), axis=1)
        return jnp.sum(h * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(a),
                                                     jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    got = torch.autograd.grad((rglru.scan(ta, tb) * torch.from_numpy(w))
                              .sum(), [ta, tb])
    for g, wt in zip(got, want):
        wt = np.asarray(wt)
        assert np.abs(g.numpy() - wt).max() <= 1e-5 * np.abs(wt).max()
    assert jrglru._C == rglru._C


def test_moe_gradient_reaches_only_kept_choices():
    """Capacity drops choices: a token whose every choice is dropped
    gets no gradient through the experts, the trash row none at all;
    the layer's gradients equal the reference's ``_moe_math``'s."""
    _, tcfg = _cfgs("mixtral_8x22b")
    tcfg = dataclasses.replace(tcfg, capacity_factor=0.5)
    jcfg = dataclasses.replace(jconfigs.smoke("mixtral_8x22b"),
                               dtype="float32", capacity_factor=0.5)
    p = moe.init_params(torch.Generator().manual_seed(0), tcfg)
    p.requires_grad_(True)
    x = torch.randn(2, 16, tcfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    x.requires_grad_(True)
    y, aux = moe.moe_ffn(x, p, tcfg)
    assert float(aux["drop_frac"]) > 0
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2))
    names = ["wr", "w1", "w3", "w2"]
    got = torch.autograd.grad(y, [x] + [getattr(p, n) for n in names], gy)
    # a token none of whose choices is kept only reaches the router
    logits = x.reshape(-1, tcfg.d_model) @ p.wr
    eids = torch.topk(torch.softmax(logits, -1), tcfg.top_k, -1).indices
    t, k = eids.shape
    cap = max(1, int(tcfg.capacity_factor * t * k / tcfg.n_experts))
    dp = moe.dispatch(eids, tcfg.n_experts, cap)
    kept = torch.zeros(t * k, dtype=torch.bool)
    kept[dp["order"]] = dp["keep"]
    dropped = ~kept.reshape(t, k).any(1)
    assert bool(dropped.any())
    y_flat = y.detach().reshape(t, -1)
    assert bool((y_flat[dropped] == 0).all())

    def jloss(x_, *w):
        yy, _ = jmoe._moe_math(x_, dict(zip(names, w)), jcfg)
        return jnp.sum(yy * jnp.asarray(gy.numpy()))

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(5))))(
        jnp.asarray(x.detach().numpy()),
        *[jnp.asarray(getattr(p, n).detach().numpy()) for n in names])
    for g, wt in zip(got, want):
        wt = np.asarray(wt)
        assert np.abs(g.numpy() - wt).max() <= 1e-5 * np.abs(wt).max()


# --------------------------------- remat ---------------------------------

@pytest.mark.parametrize("arch", ["qwen15_4b", "mixtral_8x22b"])
def test_remat_modes_give_bit_equal_gradients(arch):
    _, tcfg, _, tp = _pair(arch)
    batch = _batch(tcfg, 2, 24, 6)
    out = {r: _grads(tp, tcfg, batch, r) for r in ("none", "full", "dots")}
    for r in ("full", "dots"):
        assert torch.equal(out[r][0], out["none"][0])
        for k, g in out["none"][2].items():
            assert torch.equal(out[r][2][k], g), (r, k)
        for k, v in out["none"][1].items():
            assert torch.equal(out[r][1][k], v), (r, k)
