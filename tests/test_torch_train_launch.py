"""repro_torch's training launcher for every family and the reference's
dense presets, a family's train state through a checkpoint, and
``dist/compress.py`` against repro's.

The launcher runs in this process on the CPU.  Its tokens are uniform
random, and at the tests' 2 x 16 tokens a step a fresh batch moves the
loss by more than a few steps of training do, so the launcher's own
check (the last step's loss below the first's) would read noise: the
runs here repeat step 0's batch (tokens, image tokens and frames) at
every step, and then the loss falls for a reason.

Tolerances: exact throughout (the presets field for field, the loss
trails of a restarted and an uninterrupted run, a restored state, the
int8 codes and scales of ``quantize``)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compress as jcompress
from repro.launch import train as jtrain
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data import tokens as data_tokens
from repro_torch.dist import compress
from repro_torch.launch import train
from repro_torch.models import api
from repro_torch.optim import adamw

torch.set_num_threads(1)
RUNS = [[], ["--preset", "20m"], ["--preset", "100m"],
        ["--arch", "internvl2_26b", "--smoke"],
        ["--arch", "whisper_medium", "--smoke"]]


def _run(argv, tmp_path, *extra, repeat=False, monkeypatch=None):
    """``train.main`` on the CPU at 2 x 16 tokens (step 0's batch at
    every step with ``repeat``) -> each completed step's metrics."""
    if repeat:
        made = train.make_batch
        monkeypatch.setattr(train, "make_batch",
                            lambda pipe, cfg, step, dev: made(pipe, cfg, 0,
                                                              dev))
    seen = []
    rc = train.main(argv + ["--device", "cpu", "--batch", "2", "--seq", "16",
                            "--ckpt-dir", str(tmp_path / "ckpt"),
                            "--log-every", "1", *extra],
                    on_step=lambda i, m: seen.append(m))
    assert rc == 0
    return seen


def test_presets_equal_repro():
    assert sorted(train.PRESETS) == sorted(jtrain.PRESETS)
    for name, cfg in train.PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jtrain.PRESETS[name])
    assert train.config_of(None, None, False) is train.PRESETS["20m"]
    assert train.config_of(None, "gemma2_27b", True) == configs.smoke(
        "gemma2_27b")


@pytest.mark.parametrize("argv", RUNS, ids=["default", "20m", "100m",
                                            "vlm", "encdec"])
def test_train_launcher_runs_on_cpu(argv, tmp_path, capsys, monkeypatch):
    """Three steps; the loss falls (the launcher checks it) and every
    metric is finite."""
    seen = _run(argv, tmp_path, "--steps", "3", repeat=True,
                monkeypatch=monkeypatch)
    out = capsys.readouterr().out
    name = (train.PRESETS[argv[1]].name if argv[:1] == ["--preset"] else
            configs.smoke(argv[1]).name if argv else "repro-20m")
    assert f"arch={name} " in out and "device=cpu" in out
    assert "restarts=0" in out and len(seen) == 3
    assert seen[-1]["loss"] < seen[0]["loss"]
    assert all(np.isfinite(v) for m in seen for v in m.values())


@pytest.mark.parametrize("argv", [[], ["--arch", "whisper_medium", "--smoke"],
                                  ["--arch", "mixtral_8x22b", "--smoke"]],
                         ids=["20m", "encdec", "moe"])
def test_restart_gives_a_bit_equal_loss_trail(argv, tmp_path, monkeypatch):
    """Six steps with a checkpoint every 2 and a failure at step 3 (the
    state restored from step 2, step 2 run again) against an
    uninterrupted run: every step's metrics equal."""
    kw = dict(repeat=True, monkeypatch=monkeypatch)
    whole = _run(argv, tmp_path / "whole", "--steps", "6", "--ckpt-every",
                 "7", **kw)
    again = _run(argv, tmp_path / "again", "--steps", "6", "--ckpt-every",
                 "2", "--inject-failure-at", "3", **kw)
    assert len(again) == 7
    assert again[:3] + again[4:] == whole and again[3] == whole[2]
    assert sorted(os.listdir(tmp_path / "again" / "ckpt")) == [
        "step_00000002", "step_00000004", "step_00000006"]


def test_make_batch_adds_the_family_inputs():
    """A vlm's zero image tokens; an encoder-decoder's bf16 frames from
    a generator seeded with the step index (the same step gives the
    same frames, on any device)."""
    pipe = data_tokens.TokenPipelineConfig(vocab=512, seq_len=8,
                                           global_batch=2)
    vlm = configs.smoke("internvl2_26b")
    b = train.make_batch(pipe, vlm, 0, "cpu")
    assert b["img"].shape == (2, vlm.vis_tokens, vlm.vis_dim)
    assert b["img"].dtype == torch.bfloat16 and not b["img"].any()
    enc = configs.smoke("whisper_medium")
    f0, f0b, f1 = (train.make_batch(pipe, enc, s, "cpu")["frames"]
                   for s in (0, 0, 1))
    assert f0.shape == (2, enc.src_len, enc.d_model)
    assert f0.dtype == torch.bfloat16 and torch.equal(f0, f0b)
    assert not torch.equal(f0, f1)
    want = torch.randn((2, enc.src_len, enc.d_model),
                       generator=torch.Generator().manual_seed(1))
    assert torch.equal(f1, want.to(torch.bfloat16))
    assert set(train.make_batch(pipe, configs.smoke("qwen15_4b"), 0,
                                "cpu")) == {"tokens"}


@pytest.mark.parametrize("arch", ["gemma2_27b", "mixtral_8x22b",
                                  "recurrentgemma_9b", "internvl2_26b",
                                  "whisper_medium"])
def test_family_train_state_survives_a_checkpoint(arch, tmp_path):
    """One step (moments nonzero), ``store.save``, ``store.restore`` into
    a fresh state: parameters, moments and steps bit for bit, and the
    next step's metrics equal from either."""
    cfg = configs.smoke(arch)
    model = api.build(cfg, "cpu")
    opt = adamw.AdamWConfig(warmup=0)
    step = api.make_train_step(model, opt)
    pipe = data_tokens.TokenPipelineConfig(vocab=cfg.vocab, seq_len=12,
                                           global_batch=2)
    state = api.init_train_state(model, torch.Generator().manual_seed(0),
                                 opt)
    state, _ = step(state, train.make_batch(pipe, cfg, 0, "cpu"))
    store.save(str(tmp_path), state, 1)
    fresh = api.init_train_state(model, torch.Generator().manual_seed(9),
                                 opt)
    got, at = store.restore(str(tmp_path), fresh)
    assert at == 1 and int(got.step) == 1 == int(got.opt.step)
    for (ka, a), (kb, b) in zip(state.params.named_parameters(),
                                got.params.named_parameters()):
        assert ka == kb and torch.equal(a, b) and b.requires_grad
    for part in ("m", "v"):
        for k, a in getattr(state.opt, part).items():
            assert torch.equal(a, getattr(got.opt, part)[k])
    batch = train.make_batch(pipe, cfg, 1, "cpu")
    _, m_got = step(got, batch)
    _, m_want = step(state, batch)
    assert {k: float(v) for k, v in m_got.items()} == {
        k: float(v) for k, v in m_want.items()}


# ------------------------------ compression ------------------------------

def _quantize_cases():
    rng = np.random.default_rng(0)
    # max |x| = 127 makes the scale exactly 1: x / scale keeps the .5s
    halves = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5,
                       -127.0], np.float32)
    return {"normal": (rng.standard_normal(4096) * 3).astype(np.float32),
            "zeros": np.zeros(64, np.float32),
            "halves": halves,
            # normal values whose max / 127 falls below float32's tiny:
            # the scale is the floor (no subnormal input: XLA:CPU flushes
            # those to zero and torch does not)
            "floor": (rng.uniform(1.2e-38, 1.4e-36, 64) * rng.choice(
                [-1, 1], 64)).astype(np.float32),
            "matrix": rng.standard_normal((33, 65)).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(_quantize_cases()))
def test_quantize_and_dequantize_equal_repro(case):
    """Bit for bit with the reference's eager form: the codes, the scale
    (a true division by 127, at least float32's tiny) and the
    dequantised values; half steps round to even."""
    x = _quantize_cases()[case]
    jq, js = jcompress.quantize(jnp.asarray(x))
    q, s = compress.quantize(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(
        compress.dequantize(q, s).numpy(),
        np.asarray(jcompress.dequantize(jq, js)))
    if case == "halves":
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 4, 126, -127]
    if case in ("zeros", "floor"):
        assert float(s) == np.finfo(np.float32).tiny
        assert q.any() == (case == "floor")
    err = (compress.dequantize(q, s) - torch.from_numpy(x)).abs()
    assert bool((err <= s / 2).all())


def test_compressed_psum_without_a_mesh_keeps_the_residual():
    """One rank: the reduction is the dequantised compensated value, the
    residual what quantisation lost; over 20 steps of the reference's
    case (``tests/test_multidevice.py``) the accumulated drift stays
    under 1%."""
    g = {"w": torch.linspace(-1, 1, 64)}
    err = {"w": torch.zeros(64)}
    red, new = compress.compressed_psum(g, None, err)
    q, s = compress.quantize(g["w"])
    assert torch.equal(red["w"], compress.dequantize(q, s))
    assert torch.equal(new["w"], g["w"] - red["w"])
    acc_true, acc_q = torch.zeros(64), torch.zeros(64)
    for _ in range(20):
        red, err = compress.compressed_psum(g, None, err)
        acc_true += g["w"]
        acc_q += red["w"]
    rel = float((acc_q - acc_true).abs().max() / acc_true.abs().max())
    assert rel < 0.01
