"""repro_torch's encoder-decoder family (whisper-medium's structure at
the smoke config: 2 encoder and 2 decoder layers, 24 source frames)
against repro's, with the helpers of ``tests/test_torch_dense.py``:
the bidirectional encoder, the teacher-forced decoder, the cross
K/V cache, 40 decode steps, the greedy tokens, the conversion and the
init; and the encoder at whisper's 1,500 frames, which pad to 1,536
keys (three 512-key chunks, the last part padding).

Tolerances as there: float32 logits within 1e-4, bf16 within 3e-2; the
encoder output within 1e-5 (float32) at 1,500 frames."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import encdec as jencdec
from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import api, convert, encdec
from test_torch_dense import (check_convert, check_decode, check_forward,
                              check_init, check_tokens)

torch.set_num_threads(1)
ARCH = "whisper_medium"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_repro(dtype):
    aux, jaux, _ = check_forward(ARCH, dtype)
    assert aux == {} and jaux == {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_repro_and_teacher_forcing(dtype):
    check_decode(ARCH, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_serve_steps_give_repro_tokens(dtype):
    check_tokens(ARCH, dtype)


def test_convert_names_every_tensor_after_repro_and_round_trips():
    check_convert(ARCH)


def test_random_init_is_seeded_and_shaped_as_repro():
    check_init(ARCH)


def test_encoder_pads_1500_frames_as_repro():
    """One encoder layer at whisper's source length (1,500 frames, 1,536
    padded keys), narrow widths; and the cross cache's roped keys."""
    cfg = dataclasses.replace(jconfigs.smoke(ARCH), dtype="float32",
                              src_len=1500, enc_layers=1, n_layers=1)
    tcfg = dataclasses.replace(configs.smoke(ARCH), dtype="float32",
                               src_len=1500, enc_layers=1, n_layers=1)
    p = jencdec.init_params(jax.random.PRNGKey(5), cfg)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), tcfg, "cpu")
    frames = np.random.default_rng(6).standard_normal(
        (1, 1500, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda pp, f: jencdec.encode(pp, f, cfg))(
        p, jnp.asarray(frames))
    got = encdec.encode(tp, torch.from_numpy(frames), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jc = jax.jit(lambda pp, f: jencdec.init_cache(pp, f, cfg, 4))(
        p, jnp.asarray(frames))
    tc = encdec.init_cache(tp, torch.from_numpy(frames), tcfg, 4)
    for k in ("k", "v"):
        np.testing.assert_allclose(tc["cross"][0][k].numpy(),
                                   np.asarray(jc["cross"][k][0]), rtol=1e-5,
                                   atol=1e-5)
        assert tc["self"][0][k].shape == (1, 4, cfg.n_kv, cfg.hd)


def test_encdec_model_has_no_lm_cache_and_does_not_train():
    """No LM cache, as in repro; and one train step runs: finite loss
    and grad_norm, every parameter moved (the tests of the loss against
    repro's are in ``tests/test_torch_train_families.py``)."""
    from repro_torch.optim import adamw
    tcfg = configs.smoke(ARCH)
    model = api.build(tcfg, "cpu")
    assert model.init_cache is None
    opt = adamw.AdamWConfig(warmup=0)
    state = api.init_train_state(model, torch.Generator().manual_seed(0),
                                 opt)
    before = [p.detach().clone() for p in state.params.parameters()]
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, tcfg.vocab, (2, 8), generator=g),
             "frames": torch.randn(2, tcfg.src_len, tcfg.d_model,
                                   generator=g)}
    state, metrics = api.make_train_step(model, opt)(state, batch)
    assert sorted(metrics) == ["grad_norm", "loss", "lr"]
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert all(not torch.equal(a, p.detach()) for a, p in zip(
        before, state.params.parameters()))


def test_serve_launcher_runs_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "4", "--gen", "3"]) == 0
    out = capsys.readouterr().out
    assert "generated 6 tokens" in out and "device=cpu" in out
