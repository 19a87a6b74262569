"""repro_torch's dense and vlm families against repro's at the smoke
config (``configs.smoke``): gemma2 (local and global layers, both
softcaps, post-norms, tied embeddings, gelu), stablelm, qwen1.5 (QKV
bias), command-r, and internvl2 (the image prefix).  repro's
``init_params(PRNGKey(0))`` is carried across by
``convert.params_from_numpy``; tokens and images are drawn with numpy.

Tolerances: float32 logits within 1e-4 (rtol = atol,
``tests/test_models_smoke.py``'s); bf16 logits within 3e-2 absolute
(``tests/test_torch_lm.py``'s ``BF16_ATOL``: both sides round to bf16,
not at the same places).  Greedy tokens must agree wherever the
reference's top-two margin exceeds twice the tolerance, up to the first
step where it does not (a near-tie may flip, and every later token
with it).

The helpers here serve ``tests/test_torch_moe_hybrid.py`` and
``tests/test_torch_encdec.py`` too."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import api, convert, encdec, lm

torch.set_num_threads(1)
ARCHS = ["gemma2_27b", "stablelm_12b", "qwen15_4b", "command_r_35b",
         "internvl2_26b"]
BF16_ATOL = 3e-2
F32 = dict(rtol=1e-4, atol=1e-4)


def cfgs(arch, dtype, **kw):
    return (dataclasses.replace(jconfigs.smoke(arch), dtype=dtype, **kw),
            dataclasses.replace(configs.smoke(arch), dtype=dtype, **kw))


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return japi.build(jconfigs.smoke(arch)).init_params(
        jax.random.PRNGKey(0))


def params(arch, tcfg):
    """repro's smoke parameters (float32 whatever the activations' type)
    and the port's copy of them."""
    p = _jparams(arch)
    return p, convert.params_from_numpy(jax.tree.map(np.asarray, p), tcfg,
                                        "cpu")


def inputs(cfg, b, s, seed=1):
    """numpy tokens, and the vlm's image or the encdec's frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["img"] = rng.standard_normal(
            (b, cfg.vis_tokens, cfg.vis_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, cfg.src_len, cfg.d_model)).astype(np.float32)
    return out


def tol(dtype, bf16_atol=BF16_ATOL):
    return F32 if dtype == "float32" else dict(rtol=0, atol=bf16_atol)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def forwards(cfg, tcfg, p, tp, batch, mode="all"):
    """(repro's logits and aux, jitted; the port's logits and aux)."""
    if cfg.family == "encdec":
        jb, tb = _j(batch), _t(batch)
        want = jax.jit(lambda pp, b: jencdec.forward(
            pp, b["frames"], b["tokens"], cfg, logits_mode=mode))(p, jb)
        got = encdec.forward(tp, tb["frames"], tb["tokens"], tcfg,
                             logits_mode=mode)
    else:
        jb, tb = _j(batch), _t(batch)
        want = jax.jit(lambda pp, b: jlm.forward(
            pp, b["tokens"], cfg, img=b.get("img"), remat="none",
            logits_mode=mode))(p, jb)
        got = lm.forward(tp, tb["tokens"], tcfg, img=tb.get("img"),
                         logits_mode=mode)
    return (np.asarray(want[0]), want[1]), (got[0].numpy(), got[1])


def check_forward(arch, dtype, s=40, bf16_atol=BF16_ATOL, **kw):
    """Logits of both modes against repro's -> the port's aux and
    repro's, and the (batch, position) rows' largest gaps."""
    cfg, tcfg = cfgs(arch, dtype, **kw)
    p, tp = params(arch, tcfg)
    batch = inputs(cfg, 2, s)
    n = s + (cfg.vis_tokens if cfg.family == "vlm" else 0)
    gaps = []
    for mode in ("all", "last"):
        (want, jaux), (got, aux) = forwards(cfg, tcfg, p, tp, batch, mode)
        assert got.dtype == np.float32
        assert got.shape == (2, n if mode == "all" else 1, cfg.vocab_padded)
        np.testing.assert_array_equal(got[..., cfg.vocab:], -1e9)
        np.testing.assert_allclose(got[..., :cfg.vocab],
                                   want[..., :cfg.vocab],
                                   **tol(dtype, bf16_atol))
        gaps.append(np.abs(got - want)[..., :cfg.vocab].max(-1).ravel())
    return aux, jaux, np.concatenate(gaps)


def _init_cache(cfg, model, p, batch, b, max_len, port):
    if cfg.family != "encdec":
        return model.init_cache(b, max_len)
    if port:
        return encdec.init_cache(p, torch.from_numpy(batch["frames"]), cfg,
                                 max_len)
    return jencdec.init_cache(p, jnp.asarray(batch["frames"]), cfg, max_len)


def check_decode(arch, dtype, s=40, bf16_atol=BF16_ATOL, **kw):
    """``s`` decode steps against repro's (jitted) and, in float32,
    against the port's own teacher-forced forward (the vlm decodes text
    alone, as the reference's decode step takes no image) -> the
    (batch, step) rows' largest gaps to repro."""
    cfg, tcfg = cfgs(arch, dtype, **kw)
    p, tp = params(arch, tcfg)
    jmodel, model = japi.build(cfg), api.build(tcfg, "cpu")
    batch = inputs(cfg, 2, s)
    batch.pop("img", None)
    toks = batch["tokens"]
    tf = forwards(cfg, tcfg, p, tp, batch)[1][0]
    jcache = _init_cache(cfg, jmodel, p, batch, 2, s, False)
    cache = _init_cache(tcfg, model, tp, batch, 2, s, True)
    jstep = jax.jit(jmodel.decode_step)
    t = tol(dtype, bf16_atol)
    gaps = []
    for pos in range(s):
        jl, jcache = jstep(p, jcache, jnp.asarray(toks[:, pos]), pos)
        with torch.no_grad():
            logits, cache = model.decode_step(
                tp, cache, torch.from_numpy(toks[:, pos]), pos)
        got, jl = logits.numpy()[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab]
        np.testing.assert_allclose(got, jl, **t)
        gaps.append(np.abs(got - jl).max(-1))
        if dtype == "float32":
            np.testing.assert_allclose(got, tf[:, pos, :cfg.vocab], **t)
    return np.concatenate(gaps)


def _margin(logits):
    top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def check_tokens(arch, dtype, bf16_atol=BF16_ATOL, **kw):
    """``make_prefill_step``'s greedy tokens and ``serve.generate``'s
    (prompt 8, gen 16) against repro's prefill step and greedy loop."""
    cfg, tcfg = cfgs(arch, dtype, **kw)
    p, tp = params(arch, tcfg)
    jmodel, model = japi.build(cfg), api.build(tcfg, "cpu")
    batch = inputs(cfg, 4, 24, seed=5)
    margin = 2 * tol(dtype, bf16_atol)["atol"]
    want = jax.jit(japi.make_prefill_step(jmodel))(p, _j(batch))
    got = api.make_prefill_step(model)(tp, _t(batch))
    assert got.shape == (4, cfg.vocab_padded)
    decided = _margin(want) > margin
    np.testing.assert_array_equal(got.argmax(-1).numpy()[decided],
                                  np.asarray(want).argmax(-1)[decided])

    # repro's greedy loop (src/repro/launch/serve.py), keeping the logits
    toks = batch["tokens"]
    jcache = _init_cache(cfg, jmodel, p, batch, 4, 24, False)
    jstep = jax.jit(jmodel.decode_step)
    tok, jout, jmargin = jnp.asarray(toks[:, 0]), [], []
    for pos in range(23):
        logits, jcache = jstep(p, jcache, tok, pos)
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)
        tok = jnp.asarray(toks[:, pos + 1]) if pos + 1 < 8 else nxt
        if pos + 1 >= 8:
            jout.append(np.asarray(nxt))
            jmargin.append(_margin(logits[:, :cfg.vocab]))
    frames = (torch.from_numpy(batch["frames"]) if cfg.family == "encdec"
              else None)
    got = serve.generate(model, tp, torch.from_numpy(toks[:, :8]), 16,
                         frames=frames)
    assert got.dtype == torch.int32 and got.shape == (4, 16)
    jout, jmargin = np.stack(jout, 1), np.stack(jmargin, 1)
    # each row up to its first near-tie
    agreed = 0
    for r in range(4):
        n = int(np.argmin(jmargin[r] > margin)) if not (
            jmargin[r] > margin).all() else 16
        np.testing.assert_array_equal(got.numpy()[r, :n], jout[r, :n])
        agreed += n
    if dtype == "float32":      # bf16's smoke margins are mostly ties
        assert agreed >= 48 and decided.sum() >= 3


def ref_named(arch):
    """repro's smoke tree as the port's parameter names -> arrays: a
    stacked leaf's layer ``i`` of pattern position ``j`` is block
    ``i * len(pattern) + j``, rest layer ``r`` follows them, and the
    encoder-decoder's ``enc``/``dec`` leaves are per layer."""
    cfg = jconfigs.smoke(arch)
    pat, n_super, _ = jlm.structure(cfg)
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(_jparams(arch)):
        keys = [k.key for k in path]
        if keys[0] == "blocks":
            j = int(keys[1][1:])
            for i in range(leaf.shape[0]):
                out[".".join(["blocks", str(i * len(pat) + j)] + keys[2:])] \
                    = np.asarray(leaf[i])
        elif keys[0] == "rest":
            r = n_super * len(pat) + int(keys[1][1:])
            out[".".join(["blocks", str(r)] + keys[2:])] = np.asarray(leaf)
        elif keys[0] in ("enc", "dec"):
            for i in range(leaf.shape[0]):
                out[".".join([keys[0], str(i)] + keys[1:])] = np.asarray(
                    leaf[i])
        else:
            out[".".join(keys)] = np.asarray(leaf)
    return out


def check_convert(arch):
    """Every tensor named after its key in repro's pytree, equal to it,
    and ``params_to_numpy`` giving repro's tree back."""
    _, tcfg = cfgs(arch, "float32")
    p, tp = params(arch, tcfg)
    want = ref_named(arch)
    got = dict(tp.named_parameters())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
        assert not got[k].requires_grad
    back = convert.params_to_numpy(tp, tcfg)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree.map(np.asarray, p)))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(a, np.asarray(b))


def check_init(arch):
    """Seeded, repro's shapes (``jax.eval_shape`` of its init), zero
    norms and biases, ``lam`` 4.0, every other leaf normal(0, 0.02)."""
    cfg, tcfg = cfgs(arch, "float32")
    model = api.build(tcfg, "cpu")
    a = model.init_params(torch.Generator().manual_seed(3))
    b = model.init_params(torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.named_parameters(), b.named_parameters()):
        assert ka == kb and torch.equal(va, vb)
    shapes = jax.eval_shape(japi.build(cfg).init_params,
                            jax.random.PRNGKey(0))
    tree = convert.params_to_numpy(a, tcfg)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(shapes))
    for x, want in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert x.shape == want.shape and x.dtype == np.float32
    for name, t in a.named_parameters():
        leaf = name.split(".")[-1]
        if leaf.startswith("norm") or leaf.endswith("_norm") or leaf in (
                "bq", "bk", "bv"):
            assert not t.any(), name
        elif leaf == "lam":
            assert bool((t == 4.0).all()), name
        else:
            assert abs(float(t.std()) - 0.02) < 3e-3, name
            assert abs(float(t.mean())) < 3e-3, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_repro(arch, dtype):
    aux, _, _ = check_forward(arch, dtype)
    assert aux == {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_repro_and_teacher_forcing(arch, dtype):
    check_decode(arch, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gemma2_27b", "qwen15_4b",
                                  "internvl2_26b"])
def test_prefill_and_serve_steps_give_repro_tokens(arch, dtype):
    check_tokens(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_names_every_tensor_after_repro_and_round_trips(arch):
    check_convert(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_random_init_is_seeded_and_shaped_as_repro(arch):
    check_init(arch)


def test_vlm_image_prefix_runs_before_the_text():
    """The projected patches take the first positions and the text's
    logits depend on them; without an image the model is a plain LM."""
    _, tcfg = cfgs("internvl2_26b", "float32")
    _, tp = params("internvl2_26b", tcfg)
    batch = _t(inputs(tcfg, 2, 12))
    with_img, _ = lm.forward(tp, batch["tokens"], tcfg, img=batch["img"])
    assert with_img.shape[1] == tcfg.vis_tokens + 12
    text, _ = lm.forward(tp, batch["tokens"], tcfg)
    assert text.shape[1] == 12
    assert not torch.allclose(with_img[:, tcfg.vis_tokens:], text)


@pytest.mark.parametrize("arch", ["gemma2_27b", "internvl2_26b"])
def test_serve_launcher_runs_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out and "device=cpu" in out
