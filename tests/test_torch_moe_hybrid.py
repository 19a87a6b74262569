"""repro_torch's MoE (mixtral: sliding window; arctic: the dense residual
MLP) and hybrid (recurrentgemma: RG-LRU and local attention, the first
family with ``rest`` layers) families against repro's at the smoke
config, with the helpers of ``tests/test_torch_dense.py``; the MoE
dispatch and the RG-LRU scan on their own.

Tolerances as there (float32 1e-4, bf16 3e-2), and:

* The MoE dispatch at the default capacity factor: the same experts,
  the same dropped (token, choice) pairs, ``drop_frac`` bit for bit
  (against repro's jitted ``_moe_math``: XLA multiplies by the float32
  reciprocal of the constant ``t * k`` and fuses the subtraction, and
  the port follows it), ``lb_loss`` and ``expert_skew`` within 1e-6,
  the output within 1e-5.
* MoE bf16 logits within 6e-2, and no more than two (batch, position)
  rows of a run past 3e-2: the router reads the bf16 hidden state, and
  where a token's second and third experts are a near-tie (measured:
  probabilities 5.8e-6 apart in mixtral's layer 1) one bf16 ulp of that
  state flips its second expert; that row's logits then differ by up to
  3.1e-2 (measured: forward 3.03e-2 at one row of 80, decode 3.10e-2).
  Fed the same bf16 input, the two MoE layers agree within 6.1e-5.
* The RG-LRU scan (Hillis-Steele doubling) against
  ``lax.associative_scan`` within 1e-5 relative: the same operator,
  another association order.
"""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import layers, moe, rglru
from test_torch_dense import (BF16_ATOL, check_convert, check_decode,
                              check_forward, check_init, check_tokens)

torch.set_num_threads(1)
ARCHS = ["mixtral_8x22b", "arctic_480b", "recurrentgemma_9b"]
MOE = ("mixtral_8x22b", "arctic_480b")
MOE_BF16_ATOL = 6e-2


def _atol(arch, dtype):
    return MOE_BF16_ATOL if arch in MOE and dtype == "bfloat16" else BF16_ATOL


def _few_flips(arch, dtype, gaps):
    if arch in MOE and dtype == "bfloat16":
        assert int((gaps > BF16_ATOL).sum()) <= 2, gaps.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_repro(arch, dtype):
    aux, jaux, gaps = check_forward(arch, dtype,
                                    bf16_atol=_atol(arch, dtype))
    _few_flips(arch, dtype, gaps)
    assert sorted(aux) == sorted(jaux)
    if dtype == "float32":
        for k, v in jaux.items():
            if k.endswith("drop_frac"):
                assert float(aux[k]) == float(v), k
            else:
                np.testing.assert_allclose(float(aux[k]), float(v),
                                           rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_repro_and_teacher_forcing(arch, dtype):
    """float32 at capacity factor 16 (``tests/test_models_smoke.py``: a
    decode step routes 2 tokens, the forward 80, and only a capacity no
    token exceeds drops alike); bf16 at the default against repro."""
    kw = dict(capacity_factor=16.0) if dtype == "float32" else {}
    gaps = check_decode(arch, dtype, bf16_atol=_atol(arch, dtype), **kw)
    _few_flips(arch, dtype, gaps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_serve_steps_give_repro_tokens(arch, dtype):
    check_tokens(arch, dtype, bf16_atol=_atol(arch, dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_names_every_tensor_after_repro_and_round_trips(arch):
    check_convert(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_random_init_is_seeded_and_shaped_as_repro(arch):
    check_init(arch)


def _moe_layer(arch):
    cfg, tcfg = jconfigs.smoke(arch), configs.smoke(arch)
    p = jax.tree.map(lambda a: a[0], jmoe.init_params(
        jax.random.PRNGKey(3), cfg, 1))
    tp = layers.Params({k: torch.from_numpy(np.array(v))
                        for k, v in p.items()})
    return cfg, tcfg, p, tp


def _ref_dispatch(x, p, cfg):
    """repro's ``_moe_math`` routing and dispatch, line for line: the
    expert ids and, per flat (token, choice), whether it keeps a slot."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    cap = max(1, int(cfg.capacity_factor * t * k / e))
    probs = jax.nn.softmax(x.reshape(t, d).astype(jnp.float32) @ p["wr"], -1)
    _, eids = jax.lax.top_k(probs, k)
    flat_e = eids.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    counts = jax.ops.segment_sum(jnp.ones_like(flat_e), flat_e,
                                 num_segments=e)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype),
                              jnp.cumsum(counts)[:-1]])
    rank_sorted = jnp.arange(t * k) - starts[flat_e[order]]
    keep_flat = (rank_sorted < cap)[jnp.argsort(order, stable=True)]
    return np.asarray(eids), np.asarray(keep_flat)


@pytest.mark.parametrize("shift", [0.0, 0.8, 12.8])
@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_drops_and_aux_match_repro(arch, shift):
    """float32 tokens moved by ``shift`` along expert 0's router column
    (12.8 sends most tokens there, and most of their choices drop): same
    experts, same drops, same aux."""
    cfg, tcfg, p, tp = _moe_layer(arch)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    w0 = np.asarray(p["wr"])[:, 0]
    x += (shift * w0 / np.linalg.norm(w0)).astype(np.float32)
    want, jaux = jax.jit(lambda a: jmoe._moe_math(a, p, cfg))(jnp.asarray(x))
    got, aux = moe.moe_ffn(torch.from_numpy(x), tp, tcfg)
    eids, keep = _ref_dispatch(jnp.asarray(x), p, cfg)
    logits = torch.from_numpy(x).reshape(-1, cfg.d_model) @ tp.wr
    teids = torch.topk(torch.softmax(logits, -1), cfg.top_k, -1).indices
    np.testing.assert_array_equal(teids.numpy(), eids)
    t = 2 * 40
    cap = max(1, int(cfg.capacity_factor * t * cfg.top_k / cfg.n_experts))
    dp = moe.dispatch(teids, cfg.n_experts, cap)
    tkeep = torch.empty_like(dp["keep"])
    tkeep[dp["order"]] = dp["keep"]
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    assert float(aux["drop_frac"]) == float(jaux["drop_frac"])
    if shift > 10:
        assert float(aux["drop_frac"]) > 0.2
    for k in ("lb_loss", "expert_skew"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_moe_shard_map_path_waits_for_the_mesh():
    """The shard_map MoE form (``set_local_moe``) runs: on a (1, 1)
    ``("data", "model")`` mesh, whose axes need no process group, it is
    the one-device math bit for bit; it refuses E-split experts, as the
    reference's launcher forces F-split ones.  Its 4-rank cases are in
    ``tests/test_torch_mesh.py``."""
    from repro_torch.launch import mesh as mesh_lib
    cfg = dataclasses.replace(configs.smoke("mixtral_8x22b"),
                              dtype="float32")
    p = moe.init_params(torch.Generator().manual_seed(3), cfg)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32))
    mesh = mesh_lib.ProcessMesh(None, 0, 1, torch.device("cpu"), "gloo",
                                axes=("data", "model"), dims=(1, 1))
    want, waux = moe.moe_ffn(x, p, cfg)
    moe.set_local_moe((mesh, ("data",), "model", "data"))
    try:
        got, aux = moe.moe_ffn(x, p, cfg)
        wide = mesh_lib.ProcessMesh(None, 0, 2, torch.device("cpu"), "gloo",
                                    axes=("data", "model"), dims=(1, 2))
        moe.set_local_moe((wide, ("data",), "model", "data"))
        e_split = types.SimpleNamespace(wr=p.wr[:, :4], w1=p.w1[:4],
                                        w3=p.w3[:4], w2=p.w2[:4])
        with pytest.raises(ValueError, match="F-split"):
            moe.moe_ffn(x, e_split, cfg)
    finally:
        moe.set_local_moe(None)
    assert torch.equal(got, want)
    assert {k: float(v) for k, v in aux.items()} == {
        k: float(v) for k, v in waux.items()}


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000, 1024])
def test_rglru_scan_matches_associative_scan(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 16)).astype(np.float32)
    b = rng.standard_normal((2, n, 16)).astype(np.float32)

    def op(lft, rgt):
        return lft[0] * rgt[0], lft[1] * rgt[0] + rgt[1]

    _, want = jax.jit(lambda x, y: jax.lax.associative_scan(
        op, (x, y), axis=1))(jnp.asarray(a), jnp.asarray(b))
    got = rglru.scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("lam", [4.0, 30.0])
def test_rglru_block_matches_repro_at_1024(lam):
    """The block's prefill at L = 1,024 and its decode steps; ``lam``
    30 is past torch's softplus threshold (20), where the port takes
    jax's ``logaddexp(x, 0)``."""
    cfg, tcfg = jconfigs.smoke("recurrentgemma_9b"), configs.smoke(
        "recurrentgemma_9b")
    p = jax.tree.map(lambda a: a[0], jrglru.init_params(
        jax.random.PRNGKey(4), cfg, 1))
    p["lam"] = jnp.full_like(p["lam"], lam)
    tp = layers.Params({k: torch.from_numpy(np.array(v))
                        for k, v in p.items()})
    x = np.random.default_rng(8).standard_normal(
        (2, 1024, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda a: jrglru.forward(a, p, cfg))(jnp.asarray(x))
    got = rglru.forward(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    jcache = jrglru.init_cache(cfg, 2, jnp.float32)
    cache = rglru.init_cache(tcfg, 2, torch.float32, "cpu")
    jstep = jax.jit(lambda a, c: jrglru.decode_step(a, c, p, cfg))
    for i in range(8):
        jy, jcache = jstep(jnp.asarray(x[:, i:i + 1]), jcache)
        y, cache = rglru.decode_step(torch.from_numpy(x[:, i:i + 1]), cache,
                                     tp, tcfg)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(y.numpy(), got.numpy()[:, i:i + 1],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "recurrentgemma_9b"])
def test_serve_launcher_runs_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out and "device=cpu" in out
