"""The cases of ``tests/test_substrate.py`` this slice ports, on
repro_torch's optimizer, checkpoint store, FT runtime and token
pipeline, and the train launcher on the CPU; plus the restart of a real
train step from a checkpoint, which must end where an uninterrupted run
ends, bit for bit (the same operations on the same CPU)."""
import os, sys  # noqa: E401
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import tempfile

import numpy as np
import pytest
import torch

from repro.data import tokens as jtokens
from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.data import tokens
from repro_torch.ft.runtime import FTConfig, StepFailure, run_loop
from repro_torch.launch import train
from repro_torch.models import api
from repro_torch.optim import adamw

torch.set_num_threads(1)


def test_adamw_optimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0], requires_grad=True)}
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup=0,
                            total_steps=200)
    state = adamw.init_state(params, cfg)
    for _ in range(150):
        (g,) = torch.autograd.grad(torch.sum(params["w"] ** 2),
                                   [params["w"]])
        params, state, _ = adamw.update({"w": g}, state, params, cfg)
    assert float(params["w"].detach().abs().max()) < 0.3


@pytest.mark.parametrize("policy", ["fp32", "bf16_m", "bf16_mv"])
def test_adamw_state_policies(policy):
    params = {"w": torch.ones((8, 8))}
    cfg = adamw.AdamWConfig(state_policy=policy)
    st = adamw.init_state(params, cfg)
    assert st.m["w"].dtype == (torch.bfloat16 if policy != "fp32"
                               else torch.float32)
    assert st.v["w"].dtype == (torch.bfloat16 if policy == "bf16_mv"
                               else torch.float32)
    g = {"w": torch.full((8, 8), 0.1)}
    _, st2, m = adamw.update(g, st, params, cfg)
    assert np.isfinite(float(m["grad_norm"]))
    assert st2.m["w"].dtype == st.m["w"].dtype


def test_grad_clip():
    params = {"w": torch.zeros(4)}
    cfg = adamw.AdamWConfig(grad_clip=1.0, lr=1.0, warmup=0, weight_decay=0)
    st = adamw.init_state(params, cfg)
    _, _, m = adamw.update({"w": torch.full((4,), 100.0)}, st, params, cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_checkpoint_roundtrip_and_restore():
    state = {"p": torch.arange(12.0).reshape(3, 4),
             "n": {"s": torch.ones(5, dtype=torch.bfloat16) * 1.5}}
    with tempfile.TemporaryDirectory() as d:
        store.save(d, state, 7)
        store.save(d, {"p": state["p"] * 2, "n": {"s": state["n"]["s"] * 2}},
                   9)
        assert store.latest_step(d) == 9
        got, step = store.restore(d, state)
        assert step == 9
        np.testing.assert_allclose(got["p"].numpy(), state["p"].numpy() * 2)
        assert got["n"]["s"].dtype == torch.bfloat16
        assert torch.equal(got["n"]["s"], state["n"]["s"] * 2)
        got7, _ = store.restore(d, state, step=7)
        np.testing.assert_allclose(got7["p"].numpy(), state["p"].numpy())
        meta = store.restore(d, state, map_location="meta")[0]
        assert meta["p"].device.type == "meta"


def test_checkpoint_atomicity_on_failure(monkeypatch):
    state = {"p": torch.ones(4)}
    with tempfile.TemporaryDirectory() as d:
        store.save(d, state, 1)
        calls = {"n": 0}
        orig = np.save

        def boom(*a, **k):
            calls["n"] += 1
            if calls["n"] > 1:
                raise IOError("disk died")
            return orig(*a, **k)

        monkeypatch.setattr(np, "save", boom)
        state2 = {"p": torch.ones(4), "q": torch.zeros(2)}
        with pytest.raises(IOError):
            store.save(d, state2, 2)
        monkeypatch.setattr(np, "save", orig)
        # step 1 still intact; no step_2 garbage
        assert store.latest_step(d) == 1
        assert sorted(os.listdir(d)) == ["step_00000001"]
        got, _ = store.restore(d, state)
        np.testing.assert_allclose(got["p"].numpy(), 1.0)


def test_ft_restart_resumes_from_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        cfg = FTConfig(ckpt_dir=d, ckpt_every=3, max_restarts=2)

        def step(st, _):
            return {"x": st["x"] + 1}, {}

        st, _, info = run_loop(step, {"x": torch.zeros(())}, list(range(10)),
                               cfg, inject_failure_at=7)
        assert info["restarts"] == 1
        assert float(st["x"]) == 10.0


def test_ft_gives_up_after_max_restarts():
    with tempfile.TemporaryDirectory() as d:
        cfg = FTConfig(ckpt_dir=d, ckpt_every=2, max_restarts=0)
        with pytest.raises(StepFailure):
            run_loop(lambda st, _: (st, {}), {"x": torch.zeros(())},
                     list(range(4)), cfg, inject_failure_at=1)


def test_train_state_restart_equals_an_uninterrupted_run():
    """A real train step at the smoke config: 6 steps with a checkpoint
    every 2 and a failure at step 4 restore step 4's checkpoint and end
    with the parameters, moments and counters of an uninterrupted run,
    bit for bit."""
    cfg = configs.smoke("mamba2_1p3b")
    model = api.build(cfg, "cpu")
    opt = adamw.AdamWConfig(state_policy="bf16_m")
    step_fn = api.make_train_step(model, opt)
    pipe = tokens.TokenPipelineConfig(cfg.vocab, 32, 2)

    def run(d, fail):
        state = api.init_train_state(
            model, torch.Generator().manual_seed(0), opt)
        return run_loop(
            lambda st, i: step_fn(st, tokens.batch_for_step(pipe, i)), state,
            list(range(6)), FTConfig(ckpt_dir=d, ckpt_every=2),
            inject_failure_at=fail)

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        want, _, info0 = run(d1, None)
        got, _, info = run(d2, 4)
        assert sorted(os.listdir(d2)) == ["step_00000002", "step_00000004",
                                          "step_00000006"]
    assert (info0["restarts"], info["restarts"]) == (0, 1)
    assert int(got.step) == int(want.step) == 6
    assert int(got.opt.step) == int(want.opt.step) == 6
    for (ka, a), (kb, b) in zip(want.params.named_parameters(),
                                got.params.named_parameters()):
        assert ka == kb and torch.equal(a, b) and b.requires_grad
    for k in want.opt.m:
        assert got.opt.m[k].dtype == torch.bfloat16
        assert torch.equal(want.opt.m[k], got.opt.m[k])
        assert torch.equal(want.opt.v[k], got.opt.v[k])


def test_token_pipeline_determinism_and_host_sharding():
    cfg = tokens.TokenPipelineConfig(vocab=1000, seq_len=16, global_batch=8,
                                     n_hosts=4, host_id=2)
    b1 = tokens.batch_for_step(cfg, 5)
    b2 = tokens.batch_for_step(cfg, 5)
    assert b1["tokens"].shape == (2, 16) and b1["tokens"].dtype == \
        torch.int32
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert int(b1["tokens"].min()) >= 0 and int(b1["tokens"].max()) < 1000
    other = tokens.TokenPipelineConfig(vocab=1000, seq_len=16, global_batch=8,
                                       n_hosts=4, host_id=3)
    assert not torch.equal(b1["tokens"],
                           tokens.batch_for_step(other, 5)["tokens"])
    assert not torch.equal(b1["tokens"],
                           tokens.batch_for_step(cfg, 6)["tokens"])
    assert tokens.batch_for_step(cfg, 5, dtype=torch.int64)[
        "tokens"].dtype == torch.int64


@pytest.mark.parametrize("seed,n,max_len", [(0, 2048, 8192), (3, 500, 300)])
def test_doc_lengths_equal_repro(seed, n, max_len):
    got = tokens.doc_lengths(seed, n, max_len)
    want = jtokens.doc_lengths(seed, n, max_len)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_train_launcher_runs_on_cpu_through_a_failure(capsys):
    """Six steps at the smoke config with a failure at step 3 (restored
    from step 2's checkpoint) and a falling loss; lr 1e-3 and 8 x 128
    tokens a step, so the loss falls by more than a random batch moves
    it (the tokens are uniform: only the logits' spread can be learnt)."""
    seen = []
    with tempfile.TemporaryDirectory() as d:
        assert train.main(
            ["--arch", "mamba2_1p3b", "--smoke", "--device", "cpu",
             "--steps", "6", "--batch", "8", "--seq", "128", "--lr", "1e-3",
             "--ckpt-dir", d, "--ckpt-every", "2", "--inject-failure-at",
             "3", "--log-every", "1"],
            on_step=lambda i, m: seen.append((i, m))) == 0
        assert sorted(os.listdir(d)) == ["step_00000002", "step_00000004",
                                          "step_00000006"]
    out = capsys.readouterr().out
    assert "device=cpu" in out and "restarts=1" in out
    assert [i for i, _ in seen] == list(range(1, 8))   # step 3 ran again
    assert seen[-1][1]["loss"] < seen[0][1]["loss"]
    assert all(np.isfinite(m["grad_norm"]) for _, m in seen)


@pytest.mark.parametrize("argv", [[], ["--preset", "100m"],
                                  ["--preset", "20m"]])
def test_train_launcher_dense_presets_raise_naming_their_item(argv,
                                                              monkeypatch):
    """The dense presets (and the default, ``20m``) run on the CPU: two
    steps at 2 x 8 tokens on step 0's batch repeated (a fresh batch of
    16 uniform tokens moves the loss more than a step's training), the
    loss falling as the launcher checks."""
    made = train.make_batch
    monkeypatch.setattr(train, "make_batch",
                        lambda pipe, cfg, step, dev: made(pipe, cfg, 0, dev))
    seen = []
    with tempfile.TemporaryDirectory() as d:
        assert train.main(argv + [
            "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "8",
            "--ckpt-dir", d], on_step=lambda i, m: seen.append(m)) == 0
    assert len(seen) == 2 and seen[1]["loss"] < seen[0]["loss"]
    assert train.config_of(argv[1] if argv else None, None, False) is \
        train.PRESETS[argv[1] if argv else "20m"]
