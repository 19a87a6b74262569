"""repro_torch's training path against repro's, at the smoke config (2
layers, d_model 64, state 32) on shared numpy inputs: AdamW, the loss
and its gradients, the train step, ``remat``, and the SSD backward.

Tolerances, each measured on these inputs and stated beside its check:

* AdamW ``update`` within 1e-6 relative of ``jax.jit(update)`` (eagerly
  the two agree bit for bit; under jit XLA multiplies by the reciprocal
  of a constant divisor and reassociates constant products);
  ``schedule`` within 1e-6 relative for the same reason (and XLA's cos).
* float32 loss within 1e-5 relative (measured 1.5e-7), each gradient
  within 1e-5 of its leaf's largest (measured 2.4e-6): float32 sums run
  in another order in torch than in XLA.  bf16 loss within 1e-3
  relative (measured 3.9e-5): both sides round to bf16, not at the same
  places (``tests/test_torch_lm.py``).
* A train step's new parameters within ``2 * lr`` a step of the
  reference's: Adam's first steps are sign-like (``u = g / |g|``), so a
  gradient element near zero whose sign differs by rounding moves its
  parameter by up to ``2 * lr``; loss, ``grad_norm`` and ``lr`` within
  1e-5, 1e-5 and 1e-6 relative (bf16 weight gather: ``grad_norm`` to
  1e-3, the gradients being bf16 products).
* ``remat`` "none", "full" and "dots" give bit-equal gradients: the
  recompute runs the same operations on the same inputs.
* The SSD backward within 1e-5 of each input gradient's largest.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels.ssd import ops as jops
from repro.kernels.ssd import ref as jref
from repro.models import api as japi
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.kernels.ssd import ops, ref
from repro_torch.models import api, convert, lm
from repro_torch.optim import adamw

torch.set_num_threads(1)
ARCH = "mamba2_1p3b"


def _cfgs(dtype="float32"):
    return (dataclasses.replace(jconfigs.smoke(ARCH), dtype=dtype),
            dataclasses.replace(configs.smoke(ARCH), dtype=dtype))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(a))


# ------------------------------ AdamW ---------------------------------

def _opt_case(policy, seed=0):
    rng = np.random.default_rng(seed)
    p = {"a": rng.standard_normal((8, 16)), "b": rng.standard_normal(16),
         "c": rng.standard_normal((3, 4, 5))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    g = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
         for k, v in p.items()}
    m = {k: (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
         for k, v in p.items()}
    v = {k: np.abs(rng.standard_normal(x.shape) * 0.1).astype(np.float32)
         for k, x in p.items()}
    return p, g, m, v


@pytest.mark.parametrize("policy", ["fp32", "bf16_m", "bf16_mv"])
def test_adamw_update_matches_repro(policy):
    p, g, m, v = _opt_case(0)
    jcfg = jadamw.AdamWConfig(state_policy=policy, warmup=2)
    tcfg = adamw.AdamWConfig(state_policy=policy, warmup=2)
    mdt, vdt = jadamw._m_dtype(policy), jadamw._v_dtype(policy)
    jst = jadamw.OptState(m={k: jnp.asarray(a).astype(mdt) for k, a in
                             m.items()},
                          v={k: jnp.asarray(a).astype(vdt) for k, a in
                             v.items()}, step=jnp.int32(3))
    jp, jst2, jm = jax.jit(lambda g_, s_, p_: jadamw.update(
        g_, s_, p_, jcfg))({k: jnp.asarray(a) for k, a in g.items()}, jst,
                           {k: jnp.asarray(a) for k, a in p.items()})
    keys = sorted(p)     # jax.tree.leaves order
    tst = adamw.OptState(
        m={k: torch.from_numpy(np.array(jst.m[k].astype(jnp.float32)))
           .to(adamw._m_dtype(policy)) for k in keys},
        v={k: torch.from_numpy(np.array(jst.v[k].astype(jnp.float32)))
           .to(adamw._v_dtype(policy)) for k in keys},
        step=torch.tensor(3, dtype=torch.int32))
    tp = {k: torch.from_numpy(p[k].copy()) for k in keys}
    tp2, tst2, tm = adamw.update({k: torch.from_numpy(g[k]) for k in keys},
                                 tst, tp, tcfg)
    assert tp2["a"] is tp["a"] and tst2.m["a"] is tst.m["a"]  # in place
    assert int(tst2.step) == 4 and tst2.m["a"].dtype == adamw._m_dtype(
        policy) and tst2.v["a"].dtype == adamw._v_dtype(policy)
    for k in keys:
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-12)
        for got, want in ((tst2.m[k], jst2.m[k]), (tst2.v[k], jst2.v[k])):
            np.testing.assert_allclose(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                rtol=1e-6, atol=1e-12)
    assert _rel(jm["grad_norm"], tm["grad_norm"]) < 1e-6
    assert float(jm["lr"]) == float(tm["lr"])


def test_adamw_clips_as_repro():
    """The reference's clip case: g = 100 on 4 leaves -> grad_norm 200."""
    jcfg = jadamw.AdamWConfig(grad_clip=1.0, lr=1.0, warmup=0,
                              weight_decay=0)
    tcfg = adamw.AdamWConfig(grad_clip=1.0, lr=1.0, warmup=0,
                             weight_decay=0)
    jp, _, jm = jadamw.update({"w": jnp.full(4, 100.0)},
                              jadamw.init_state({"w": jnp.zeros(4)}, jcfg),
                              {"w": jnp.zeros(4)}, jcfg)
    params = {"w": torch.zeros(4)}
    tp, _, tm = adamw.update({"w": torch.full((4,), 100.0)},
                             adamw.init_state(params, tcfg), params, tcfg)
    assert float(tm["grad_norm"]) == pytest.approx(200.0)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)


def test_schedule_matches_repro_at_every_step():
    jcfg = jadamw.AdamWConfig(warmup=7, total_steps=40)
    tcfg = adamw.AdamWConfig(warmup=7, total_steps=40)
    sched = jax.jit(lambda s: jadamw.schedule(s, jcfg))
    for step in range(41):
        got = adamw.schedule(torch.tensor(step, dtype=torch.int32), tcfg)
        want = np.asarray(sched(jnp.int32(step)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("which", ["smoke", "published"])
def test_decay_and_cast_rule_follows_repro_leaf_dims(which):
    """``lm.ref_ndims``: every leaf the reference stacks gains a
    dimension; the decayed (and bf16-cast) names are those whose
    reference leaf has two or more.  At the published config the port's
    names come from a 48-layer model of the smoke widths (the same names
    and dimensions, small tensors), held to the reference's published
    shapes."""
    cfg, tcfg = _cfgs()
    if which == "published":
        cfg = jconfigs.get(ARCH)
        tcfg = dataclasses.replace(tcfg, n_layers=cfg.n_layers)
    params = lm.init_params(torch.Generator().manual_seed(0), tcfg)
    named = lm.named_leaves(params, tcfg)
    nd = lm.ref_ndims(named, tcfg)
    decayed = sorted(k for k, n in nd.items() if n >= 2)
    per_layer = ["norm1", "ssm.a_log", "ssm.conv_w", "ssm.d_skip",
                 "ssm.dt_bias", "ssm.gnorm", "ssm.in_proj", "ssm.out_proj"]
    assert decayed == sorted(["embed"] + [
        f"blocks.{i}.{n}" for i in range(cfg.n_layers) for n in per_layer])
    assert sorted(set(nd) - set(decayed)) == ["final_norm"]
    shapes = jax.eval_shape(lambda k: jlm.init_params(k, cfg),
                            jax.random.PRNGKey(0))
    for k, n in nd.items():
        path, _ = lm.ref_path(k, tcfg)
        leaf = shapes
        for key in path:
            leaf = leaf[key]
        assert leaf.ndim == n, k
    # named_leaves walks jax.tree.leaves' order, layers in turn
    order = [tuple(str(getattr(q, "key", q)) for q in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(shapes)]
    assert list(dict.fromkeys(lm.ref_path(k, tcfg)[0] for k in named)) \
        == order


# ------------------------------ loss ----------------------------------

def _model_pair(dtype):
    cfg, tcfg = _cfgs(dtype)
    p = jlm.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), tcfg,
                                   "cpu").requires_grad_(True)
    return cfg, tcfg, p, tp


def test_loss_and_gradients_match_repro_float32():
    cfg, tcfg, p, tp = _model_pair("float32")
    toks = _tokens(cfg, 2, 40)
    (jl, _), jg = jax.value_and_grad(
        lambda pp: jlm.loss_fn(pp, {"tokens": jnp.asarray(toks)}, cfg,
                               "full"), has_aux=True)(p)
    loss, _ = lm.loss_fn(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    named = lm.named_leaves(tp, tcfg)
    grads = torch.autograd.grad(loss, list(named.values()))
    assert _rel(jl, loss.detach()) < 1e-5
    got = convert.tree_to_numpy(dict(zip(named, grads)), tcfg)
    for (path, want), have in zip(jax.tree_util.tree_leaves_with_path(jg),
                                  jax.tree.leaves(got)):
        want = np.asarray(want)
        assert have.shape == want.shape, path
        assert np.abs(have - want).max() <= 1e-5 * np.abs(want).max(), path


def test_loss_matches_repro_bf16():
    cfg, tcfg, p, tp = _model_pair("bfloat16")
    toks = _tokens(cfg, 2, 40, seed=2)
    jl, _ = jax.jit(lambda pp, t: jlm.loss_fn(pp, {"tokens": t}, cfg))(
        p, jnp.asarray(toks))
    with torch.no_grad():
        loss, _ = lm.loss_fn(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert loss.dtype == torch.float32 and _rel(jl, loss) < 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_modes_give_bit_equal_gradients(dtype):
    _, tcfg, _, tp = _model_pair(dtype)
    toks = torch.from_numpy(_tokens(tcfg, 2, 40, seed=3))
    named = lm.named_leaves(tp, tcfg)
    out = {}
    for remat in ("none", "full", "dots"):
        loss, _ = lm.loss_fn(tp, {"tokens": toks}, tcfg, remat)
        out[remat] = (loss, torch.autograd.grad(loss, list(named.values())))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="remat"):
        lm.forward(tp, toks, tcfg, remat="offload")


def test_dots_remat_saves_the_layer_products():
    """"dots" keeps the outputs of aten.mm from the forward: its
    backward recomputes no product, where "full" recomputes some."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func in (torch.ops.aten.mm.default,
                                torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    _, tcfg, _, tp = _model_pair("float32")
    toks = torch.from_numpy(_tokens(tcfg, 2, 16, seed=4))
    counts = {}
    for remat in ("none", "full", "dots"):
        loss, _ = lm.loss_fn(tp, {"tokens": toks}, tcfg, remat)
        with Count() as c:
            torch.autograd.grad(loss, list(tp.parameters()))
        counts[remat] = c.mm
    # "full" recomputes each layer's in_proj product (the recompute
    # stops at the last saved tensor, out_proj's input), "dots" none
    assert counts["full"] == counts["none"] + tcfg.n_layers, counts
    assert counts["dots"] == counts["none"], counts


# ---------------------------- train step -------------------------------

@pytest.mark.parametrize("kw", [{}, {"n_micro": 2},
                                {"bf16_weight_gather": True}],
                         ids=["plain", "n_micro2", "bf16_gather"])
def test_train_steps_match_repro(kw):
    cfg, tcfg = _cfgs()
    jmodel, model = japi.build(cfg), api.build(tcfg, "cpu")
    jopt, opt = jadamw.AdamWConfig(), adamw.AdamWConfig()
    jstate = japi.init_train_state(jmodel, jax.random.PRNGKey(0), jopt)
    state = convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), tcfg, opt, "cpu")
    jstep = jax.jit(japi.make_train_step(jmodel, jopt, **kw))
    step = api.make_train_step(model, opt, **kw)
    gn_tol = 1e-3 if kw.get("bf16_weight_gather") else 1e-5
    moved = 0.0
    for i in range(3):
        toks = _tokens(cfg, 4, 32, seed=10 + i)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        assert _rel(jm["loss"], m["loss"]) < 1e-5
        assert _rel(jm["grad_norm"], m["grad_norm"]) < gn_tol
        assert _rel(jm["lr"], m["lr"]) < 1e-6
        moved += 2 * float(jm["lr"])
        assert int(state.step) == i + 1 and int(state.opt.step) == i + 1
        want = jax.tree.leaves(jax.tree.map(np.asarray, jstate.params))
        got = jax.tree.leaves(convert.params_to_numpy(state.params, tcfg))
        for a, b in zip(want, got):
            assert np.abs(a - b).max() <= moved + 1e-7


def test_smoke_forward_and_train_step():
    """The port's mirror of tests/test_models_smoke.py's case for
    mamba2_1p3b: shapes, finite logits, a finite loss, params move."""
    tcfg = configs.smoke(ARCH)
    model = api.build(tcfg, "cpu")
    state = api.init_train_state(model, torch.Generator().manual_seed(0),
                                 adamw.AdamWConfig())
    before = [p.detach().clone() for p in state.params.parameters()]
    b, s = 2, 32
    toks = torch.randint(0, tcfg.vocab, (b, s),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _ = lm.forward(state.params, toks, tcfg, remat="none")
    assert logits.shape == (b, s, tcfg.vocab_padded)
    assert bool(torch.isfinite(logits[..., :tcfg.vocab]).all())
    step = api.make_train_step(model, adamw.AdamWConfig())
    state2, metrics = step(state, {"tokens": toks})
    assert np.isfinite(float(metrics["loss"]))
    delta = sum(float((a - p.detach()).abs().sum())
                for a, p in zip(before, state2.params.parameters()))
    assert delta > 0.0


# ------------------------------- SSD ----------------------------------

def _ssd_inputs(seed, b, l, h, p, g, s):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)) * 0.5
    dt = np.logaddexp(rng.standard_normal((b, l, h)), 0.0) * 0.1
    a_log = -np.exp(rng.standard_normal(h) * 0.3)
    bm = rng.standard_normal((b, l, g, s)) * 0.3
    cm = rng.standard_normal((b, l, g, s)) * 0.3
    return [a.astype(np.float32) for a in (x, dt, a_log, bm, cm)]


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_intra_chunk_backward_matches_repro_vjp():
    """IntraChunk with its forward swapped for the plain version (the
    kernel runs on the card only): its backward against jax.vjp of
    repro's flat ``intra_chunk_ref`` over the same (batch, head, chunk)
    items; head h reads group h // (H / G), so a group's B and C
    gradients sum its heads'."""
    bs, l, h, p, g, s, q = 2, 256, 4, 8, 2, 8, 128
    x, dt, a_log, bm, cm = _ssd_inputs(0, bs, l, h, p, g, s)
    nc, rep = l // q, h // g
    cl = np.cumsum((dt * a_log).reshape(bs, nc, q, h), 2).reshape(bs, l, h)
    gy = np.random.default_rng(1).standard_normal((bs, l, h, p)).astype(
        np.float32)

    def flat(a):       # (B, L, H, F) -> (B*H*nc, Q, F)
        return np.moveaxis(a.reshape(bs, nc, q, h, -1), 3, 1).reshape(
            bs * h * nc, q, -1)

    heads = lambda a: np.repeat(a, rep, axis=2)   # noqa: E731
    fx = [flat(x), flat(dt[..., None])[..., 0], flat(cl[..., None])[..., 0],
          flat(heads(bm)), flat(heads(cm))]
    _, vjp = jax.vjp(jref.intra_chunk_ref, *map(jnp.asarray, fx))
    want = [np.asarray(w) for w in vjp(jnp.asarray(flat(gy)))]

    def unflat(a, f):   # (B*H*nc, Q, F) -> (B, L, H, F)
        return np.moveaxis(a.reshape(bs, h, nc, q, f), 1, 3).reshape(
            bs, l, h, f)

    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in (x, dt, cl, bm, cm)]
    y = ops.IntraChunk.apply(*ins, q, ref.intra_chunk_grouped)
    y.backward(torch.from_numpy(gy))
    _close(ins[0].grad.numpy(), unflat(want[0], p))
    _close(ins[1].grad.numpy(), unflat(want[1][..., None], 1)[..., 0])
    _close(ins[2].grad.numpy(), unflat(want[2][..., None], 1)[..., 0])
    for t, w in ((ins[3], want[3]), (ins[4], want[4])):
        _close(t.grad.numpy(),
               unflat(w, s).reshape(bs, l, g, rep, s).sum(3))


def test_plain_backward_stays_finite_past_float32_decay():
    """A chunk whose decay passes exp(88.7) (dt 0.9 at A = -1 over 128
    steps): the reference's oracle-derived backward gives NaN there
    (0 * inf in the masked product); the port's, which masks the
    exponent, stays finite and agrees with it wherever that is finite."""
    q, p, s = 128, 8, 8
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, q, p)).astype(np.float32)
    dt = np.full((2, q), 0.9, np.float32)
    cl = np.cumsum(-dt, 1).astype(np.float32)
    b, c = (rng.standard_normal((2, q, s)).astype(np.float32)
            for _ in range(2))
    _, vjp = jax.vjp(jref.intra_chunk_ref, *map(jnp.asarray,
                                                (x, dt, cl, b, c)))
    want = [np.asarray(w) for w in vjp(jnp.ones((2, q, p)))]
    assert not np.isfinite(want[3]).all()        # the reference's hazard
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, cl, b,
                                                              c)]
    ref.intra_chunk_ref(*ins).sum().backward()
    for t, w in zip(ins, want):
        assert bool(torch.isfinite(t.grad).all())
        ok = np.isfinite(w)
        np.testing.assert_allclose(t.grad.numpy()[ok], w[ok], rtol=1e-5,
                                   atol=1e-5 * np.abs(w[ok]).max())


def test_ssd_forward_gradient_matches_repro():
    """jax.grad of repro's ssd_forward (its Pallas kernel in interpret
    mode under the custom_vjp) against the port's on the CPU route."""
    args = _ssd_inputs(2, 1, 256, 4, 8, 2, 8)
    w = np.random.default_rng(3).standard_normal((1, 256, 4, 8)).astype(
        np.float32)

    def jloss(*a):
        return jnp.sum(jops.ssd_forward(*a, interpret=True,
                                        use_kernel=True) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (ops.ssd_forward(*ins) * torch.from_numpy(w)).sum().backward()
    for t, wnt in zip(ins, want):
        _close(t.grad.numpy(), wnt)


def test_update_in_blocks_is_bit_identical(monkeypatch):
    """AdamW updates a large leaf in flat blocks of ``_CHUNK`` elements
    (its float32 temporaries a block's size): the parameters and
    moments equal the whole-leaf update bit for bit, over three steps,
    on contiguous and non-contiguous leaves."""
    gen = torch.Generator().manual_seed(7)
    leaves = {"w": torch.randn(300, 37, generator=gen),
              "t": torch.randn(37, 300, generator=gen).T,
              "b": torch.randn(50, generator=gen)}
    grads = {k: torch.randn(p.shape, generator=gen) for k, p in
             leaves.items()}
    cfg = adamw.AdamWConfig(warmup=1)

    def run(chunk):
        monkeypatch.setattr(adamw, "_CHUNK", chunk)
        p = {k: v.clone() for k, v in leaves.items()}
        p["t"] = leaves["t"].clone().T.T      # keep it non-contiguous
        st = adamw.init_state(p, cfg)
        for _ in range(3):
            adamw.update(grads, st, p, cfg)
        return p, st

    (pa, sa), (pb, sb) = run(1 << 26), run(1000)
    assert not pb["t"].is_contiguous()
    for k in leaves:
        assert torch.equal(pa[k], pb[k]), k
        assert torch.equal(sa.m[k], sb.m[k]) and torch.equal(sa.v[k], sb.v[k])
