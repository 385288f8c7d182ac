"""The reference's own training tests run on the port
(``tests/test_integration.py``, ``tests/test_arch_smoke.py``,
``tests/test_fault_tolerance.py``): the loss falls on structured data,
AdamW descends a quadratic, a train step descends on one batch for every
reduced configuration, and the checkpoint manager and ``Trainer``
survive failures bit for bit — on the CPU, port only, except the data
pipelines and the trainer's batches, which equal the reference's.
"""
import os

import numpy as np
import pytest
import torch

from repro.data import synthetic as ref_synthetic
from repro.configs import registry as ref_registry
from repro.train import loop as ref_loop
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import ARCH_IDS, get_reduced
from repro_torch.data.synthetic import EmbedPipeline, TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train.loop import FailureInjector, Trainer, TrainerConfig
from repro_torch.train.steps import build_train_step

B, S = 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (several pytest workers
    on one machine otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# tests/test_integration.py
# ---------------------------------------------------------------------------


def test_training_loss_decreases_on_structured_data():
    cfg = get_reduced("gemma-2b")
    tcfg = TrainerConfig(steps=40, seq_len=32, global_batch=4, q_chunk=16,
                         log_every=1000)
    tr = Trainer(cfg, tcfg, adamw.AdamWConfig(lr=3e-3, warmup_steps=5,
                                              total_steps=40), device="cpu")
    _, hist = tr.run()
    first = float(np.mean(hist[:5]))
    last = float(np.mean(hist[-5:]))
    assert last < first - 0.5, (first, last)


def test_adamw_descends_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                            total_steps=100)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init_state(cfg, params)
    for _ in range(60):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw.apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.5


def test_launcher_trains_and_its_loss_falls(capsys):
    _, history = launch_train.main(["--arch", "gemma-2b", "--reduced",
                                    "--device", "cpu", "--steps", "20"])
    assert len(history) == 20 and history[-1] < history[0]
    assert "final loss" in capsys.readouterr().out


def test_launcher_restore_at_its_last_step_runs_no_step(tmp_path, capsys):
    argv = ["--arch", "gemma-2b", "--reduced", "--device", "cpu",
            "--steps", "2", "--seq-len", "32", "--global-batch", "2",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    _, history = launch_train.main(argv)
    assert len(history) == 2
    _, history = launch_train.main(argv + ["--restore"])
    assert history == []
    assert "no step to run" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# tests/test_arch_smoke.py:57
# ---------------------------------------------------------------------------


def smoke_batch(cfg, rng) -> dict:
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    batch = {"tokens": tok, "labels": torch.roll(tok, -1, dims=1)}
    if cfg.frontend == "vision":
        batch["embeds"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model), dtype=np.float32))
        del batch["tokens"]
    if cfg.is_enc_dec:
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model), dtype=np.float32))
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_step_descends(arch):
    cfg = get_reduced(arch)
    model = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    opt = adamw.init_state(opt_cfg, dict(model.named_parameters()))
    step = build_train_step(cfg, opt_cfg, q_chunk=16, device="cpu")
    batch = smoke_batch(cfg, np.random.default_rng(0))
    losses = []
    for _ in range(4):
        model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]     # same-batch loss must descend


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
             "b": {"c": torch.full((5,), 1.5, dtype=torch.bfloat16),
                   "d": [torch.zeros(2), torch.full((3,), 7)]},
             "layers.0.attn.wq": torch.ones((2, 2), dtype=torch.float64),
             "step": 3}
    mgr.save(10, state, extra={"note": "hi"})
    got, extra, step = mgr.restore(state)
    assert step == 10 and extra == {"note": "hi"}
    assert got["step"] == 3 and isinstance(got["step"], int)
    for key in ("a", "layers.0.attn.wq"):
        assert torch.equal(got[key], state[key])
    a, b = got["b"]["c"], state["b"]["c"]
    assert a.dtype == b.dtype == torch.bfloat16
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for a, b in zip(got["b"]["d"], state["b"]["d"]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_retention_and_atomicity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"x": torch.ones(4)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.all_steps() == [3, 4]
    # a stale tmp dir never shadows a good checkpoint
    os.makedirs(os.path.join(str(tmp_path), "step_00000099.tmp"))
    assert mgr.latest_step() == 4


def test_async_checkpoint_snapshots_before_later_updates(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    x = torch.arange(3.0)
    mgr.save_async(5, {"x": x})
    x.add_(100)           # the train loop updates its tensors in place
    mgr.wait()
    assert mgr.latest_step() == 5
    got, _, _ = mgr.restore({"x": x})
    assert torch.equal(got["x"], torch.arange(3.0))


def test_failure_injection_recovery_bitwise(tmp_path):
    """Run A: 8 uninterrupted steps.  Run B: dies at step 6, restarts
    with restore from the step-4 checkpoint.  Final parameters and
    moments must be bitwise identical (deterministic data + a
    deterministic step)."""
    cfg = get_reduced("gemma-2b")
    tcfg = TrainerConfig(steps=8, seq_len=16, global_batch=2,
                         checkpoint_every=4, q_chunk=16,
                         checkpoint_dir=str(tmp_path / "b"), log_every=100)

    ta = Trainer(cfg, TrainerConfig(**{**tcfg.__dict__,
                                       "checkpoint_dir": None}),
                 device="cpu")
    state_a, hist_a = ta.run()

    tb = Trainer(cfg, tcfg, device="cpu")
    with pytest.raises(RuntimeError, match="injected node failure"):
        tb.run(injector=FailureInjector(fail_at_step=6))
    assert CheckpointManager(tcfg.checkpoint_dir).latest_step() == 4
    state_b, hist_b = Trainer(cfg, tcfg, device="cpu").run(restore=True)

    params_b = dict(state_b["params"].named_parameters())
    for n, p in state_a["params"].named_parameters():
        assert torch.equal(p, params_b[n]), n
    for k in "mv":
        for n, t in state_a["opt"][k].items():
            assert torch.equal(t, state_b["opt"][k][n]), (k, n)
    assert state_a["opt"]["step"] == state_b["opt"]["step"] == 8
    assert hist_a[-2:] == hist_b[-2:]


def test_deterministic_data_sharding_equals_the_reference():
    """A restarted or re-placed worker regenerates exactly its shard,
    the reference's batch bit for bit."""
    kw = dict(vocab_size=100, seq_len=8, global_batch=8, seed=1)
    p, ref = TokenPipeline(**kw), ref_synthetic.TokenPipeline(**kw)
    full = p.batch(step=7)
    shard1 = p.batch(step=7, shard=1, n_shards=4)
    again = p.batch(step=7, shard=1, n_shards=4)
    np.testing.assert_array_equal(shard1["tokens"], again["tokens"])
    assert full["tokens"].shape == (8, 8)
    assert shard1["tokens"].shape == (2, 8)
    for got, want in ((full, ref.batch(step=7)),
                      (shard1, ref.batch(step=7, shard=1, n_shards=4))):
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    ekw = dict(d_model=16, seq_len=8, global_batch=4, vocab_size=100,
               seed=2)
    got = EmbedPipeline(**ekw).batch(3, shard=1, n_shards=2)
    want = ref_synthetic.EmbedPipeline(**ekw).batch(3, shard=1, n_shards=2)
    for k in ("embeds", "labels"):
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ("gemma-2b", "chameleon-34b",
                                  "seamless-m4t-large-v2"))
def test_trainer_batches_equal_the_reference(arch):
    """Tokens, frontend embeddings and an encoder–decoder's
    ``enc_embeds`` from ``[seed, step, 11]``, as the reference's
    trainer draws them."""
    tcfg = dict(steps=2, seq_len=8, global_batch=2, seed=3)
    got = Trainer(get_reduced(arch), TrainerConfig(**tcfg),
                  device="cpu").batch(5)
    want = ref_loop.Trainer(ref_registry.get_reduced(arch),
                            ref_loop.TrainerConfig(**tcfg))._batch(5)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_elastic_restore_onto_other_templates(tmp_path):
    """A checkpoint restores by structure onto each template leaf's form
    and device (a tensor's device, a NumPy array); a leaf of another
    shape raises."""
    mgr = CheckpointManager(str(tmp_path))
    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
             "step": 4}
    mgr.save(1, state)
    got, _, _ = mgr.restore({"w": np.zeros((8, 8), np.float32), "step": 0})
    np.testing.assert_array_equal(got["w"], state["w"].numpy())
    got, _, _ = mgr.restore({"w": torch.empty((8, 8), device="cpu"),
                             "step": 0})
    assert got["w"].device.type == "cpu" and torch.equal(got["w"],
                                                         state["w"])
    assert got["step"] == 4
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.empty((4, 16)), "step": 0})
