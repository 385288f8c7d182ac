"""The port's training path against the JAX package on the CPU: the flash
backward, the differentiable forward with ``loss_fn``, ``remat``, the
mixed-precision cast, one AdamW step and microbatch accumulation.

Loss and every parameter's gradient are held against
``jax.value_and_grad`` of ``repro.models.model.loss_fn`` (jitted, once a
configuration) on six reduced configurations that cover every layer
kind and all three flash paths: gemma-2b (tied, MQA), gemma3-27b (the
window-16 band at ``q_chunk`` 16), deepseek-moe-16b at B = 1 (the
reference mixes MoE batch rows, ``ROADMAP.md`` §3), zamba2-7b (Mamba2
and the shared block), xlstm-350m, seamless-m4t-large-v2
(``enc_embeds``, non-causal cross flash).  One reference parameter tree
with its constant leaves perturbed goes into both packages, the
gradients come back through the same ``convert.params_from_reference``,
and a few labels are -1 (no loss).

Tolerance: 1e-4 of max |reference| in float32, per parameter.  Measured
worst: zamba2-7b's ``A_log`` at 3.5e-5 (a sum with cancellation; the
reference's jitted and op-by-op gradients differ by as much), every
other configuration below 6e-6; losses within 5e-7.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.models import attention as RA
from repro.models import model as RM
from repro.optim import adamw as RADAM
from repro.train import steps as RS
from repro_torch.configs import registry
from repro_torch.models import attention as A
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import steps
from test_torch_models import perturbed_params, port_model

ARCHS = ("gemma-2b", "gemma3-27b", "deepseek-moe-16b", "zamba2-7b",
         "xlstm-350m", "seamless-m4t-large-v2")
S, Q_CHUNK, CE_CHUNK, TOL = 32, 16, 16, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (several pytest workers
    on one machine otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got: torch.Tensor, want) -> float:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def train_batch(cfg, b: int, seed: int = 1) -> dict:
    """Seeded numpy inputs and labels, some labels -1."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "vision":
        batch["embeds"] = rng.standard_normal((b, S, cfg.d_model),
                                              dtype=np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (b, S)
                                       ).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    labels[0, :3] = -1
    labels[-1, -1] = -1
    batch["labels"] = labels
    if cfg.is_enc_dec:
        batch["enc_embeds"] = rng.standard_normal((b, S, cfg.d_model),
                                                  dtype=np.float32)
    return batch


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_loss_and_grads(tree, cfg, batch: dict):
    """The port's loss, metrics and ``{name: gradient}``."""
    model = port_model(tree, cfg)
    loss, metrics = M.loss_fn(model, as_torch(batch), q_chunk=Q_CHUNK,
                              ce_chunk=CE_CHUNK)
    loss.backward()
    return loss, metrics, {n: p.grad for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def reference():
    """``reference(arch)`` -> (tree, batch, loss, metrics, gradients in
    the port's names), each computed once per module."""
    runs = {}

    def get(arch):
        if arch not in runs:
            cfg = ref_registry.get_reduced(arch)
            tree = perturbed_params(cfg)
            batch = train_batch(cfg, 1 if cfg.moe is not None else 2)
            f = jax.jit(jax.value_and_grad(
                lambda p, b: RM.loss_fn(p, cfg, b, q_chunk=Q_CHUNK,
                                        ce_chunk=CE_CHUNK), has_aux=True))
            (loss, metrics), grads = f(
                tree, {k: jnp.asarray(v) for k, v in batch.items()})
            grads = convert.params_from_reference(
                jax.tree.map(np.asarray, grads), registry.get_reduced(arch))
            runs[arch] = (tree, batch, float(loss),
                          {k: float(v) for k, v in metrics.items()}, grads)
        return runs[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_the_reference(arch, reference):
    tree, batch, want_loss, want_metrics, want = reference(arch)
    loss, metrics, grads = port_loss_and_grads(
        tree, registry.get_reduced(arch), batch)
    assert abs(float(loss.detach()) - want_loss) <= TOL * abs(want_loss)
    for k in ("loss", "aux"):
        assert abs(float(metrics[k]) - want_metrics[k]) <= TOL * max(
            abs(want_metrics[k]), 1e-6), k
    assert grads.keys() == want.keys()
    errs = {n: rel(g, want[n]) for n, g in grads.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= TOL, (worst, errs[worst])


FLASH_CASES = {
    # name: (sq, sk, H, KV, keywords)
    "causal-padded": (40, 40, 4, 2, {"causal": True}),
    "band": (48, 48, 2, 1, {"causal": True, "window": 16}),
    "cross-padded-keys": (24, 37, 4, 4, {"causal": False}),
    "gqa": (32, 32, 8, 2, {"causal": True}),
}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_matches_the_reference_vjp(case):
    sq, sk, h, kv, kw = FLASH_CASES[case]
    kw = dict(kw, q_chunk=16, kv_chunk=16)
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal(shape, dtype=np.float32) for shape in
               ((2, sq, h, 8), (2, sk, kv, 8), (2, sk, kv, 8)))
    dout = rng.standard_normal((2, sq, h, 8), dtype=np.float32)

    @jax.jit
    def reference_vjp(q, k, v, dout):
        out, vjp = jax.vjp(lambda *a: RA.flash_attention(*a, **kw), q, k, v)
        return out, vjp(dout)

    out, want = reference_vjp(*map(jnp.asarray, (q, k, v, dout)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got_out = A.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(got_out, (tq, tk, tv),
                              torch.from_numpy(dout))
    assert rel(got_out, out) <= TOL
    for name, g, w in zip("qkv", got, want):
        assert rel(g, w) <= TOL, name


@pytest.mark.parametrize("arch", ("gemma3-27b", "zamba2-7b",
                                  "seamless-m4t-large-v2"))
def test_remat_modes_give_equal_loss_and_gradients(arch):
    """``"full"`` and ``"dots"`` recompute (gemma3's scanned groups and
    tail, zamba2's groups with the shared block, seamless's encoder and
    decoder) what ``"none"`` keeps, bit for bit."""
    cfg = registry.get_reduced(arch)
    tree = perturbed_params(ref_registry.get_reduced(arch))
    batch = train_batch(cfg, 2)
    runs = {mode: port_loss_and_grads(
        tree, dataclasses.replace(cfg, remat=mode), batch)
        for mode in ("none", "full", "dots")}
    loss, _, grads = runs["none"]
    for mode in ("full", "dots"):
        assert torch.equal(runs[mode][0], loss), mode
        for n, g in grads.items():
            assert torch.equal(runs[mode][2][n], g), (mode, n)


def test_bfloat16_activations_give_every_float32_master_a_gradient():
    """At full width the masters are float32 and the activations
    bfloat16: the training path's cast (``compute_params``) carries the
    gradient back to every master, where serving's ``cast_params`` copy
    is detached from them."""
    cfg = dataclasses.replace(registry.get_reduced("gemma-2b"),
                              activation_dtype="bfloat16", remat="full")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = as_torch(train_batch(cfg, 2))
    loss, _ = M.loss_fn(model, batch, q_chunk=Q_CHUNK)
    loss.backward()
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None, n
        assert p.grad.dtype == torch.float32 and bool(p.grad.any()), n
    served = M.cast_params(model, cfg.activation_dtype)
    assert served.dtype == torch.bfloat16
    assert not any(p.requires_grad for p in served.state_dict().values())


@pytest.mark.parametrize("state_dtype", (None, "bfloat16"))
def test_one_adamw_step_matches_the_reference(state_dtype):
    rng = np.random.default_rng(3)
    shapes = {"a": (16, 8), "b": (8,), "c": (4, 3, 5)}
    params = {n: rng.standard_normal(s, dtype=np.float32)
              for n, s in shapes.items()}
    grads = {n: 2.0 * rng.standard_normal(s, dtype=np.float32)
             for n, s in shapes.items()}
    kw = dict(lr=0.05, warmup_steps=3, total_steps=20,
              state_dtype=state_dtype)
    rcfg, cfg = RADAM.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rp = {n: jnp.asarray(v) for n, v in params.items()}
    rstate = RADAM.init_state(rcfg, rp)
    rupdate = jax.jit(functools.partial(RADAM.apply_updates, rcfg))
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    state = adamw.init_state(cfg, tp)
    for _ in range(2):          # the second step reads non-zero moments
        rp, rstate, rmetrics = rupdate(
            rp, {n: jnp.asarray(g) for n, g in grads.items()}, rstate)
        tp, state, metrics = adamw.apply_updates(
            cfg, tp, {n: torch.from_numpy(g) for n, g in grads.items()},
            state)
    assert state["step"] == int(rstate["step"]) == 2
    assert float(metrics["lr"]) == pytest.approx(float(rmetrics["lr"]),
                                                 rel=1e-6)
    assert float(metrics["grad_norm"]) == pytest.approx(
        float(rmetrics["grad_norm"]), rel=1e-6)
    for n in shapes:
        assert rel(tp[n], rp[n]) <= 1e-6, n
        for k in "mv":
            want = np.asarray(rstate[k][n].astype(jnp.float32))
            assert rel(state[k][n], want) <= (
                1e-6 if state_dtype is None else 1e-2), (k, n)


def test_accum2_matches_the_reference():
    """``build_train_step(accum=2)``: two microbatches of 2, gradients
    accumulated in float32 and halved, metrics averaged, then AdamW."""
    arch = "gemma-2b"
    rcfg, cfg = ref_registry.get_reduced(arch), registry.get_reduced(arch)
    tree = perturbed_params(rcfg)
    batch = train_batch(cfg, 4)
    kw = dict(lr=3e-3, warmup_steps=1, total_steps=10)
    ropt = RADAM.AdamWConfig(**kw)
    rparams = jax.tree.map(jnp.asarray, tree)
    rstep = jax.jit(RS.build_train_step(rcfg, ropt, q_chunk=Q_CHUNK,
                                        accum=2))
    rparams, rstate, rmetrics = rstep(
        rparams, RADAM.init_state(ropt, rparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_model(tree, cfg)
    opt_cfg = adamw.AdamWConfig(**kw)
    step = steps.build_train_step(cfg, opt_cfg, q_chunk=Q_CHUNK, accum=2,
                                  device="cpu")
    model, state, metrics = step(
        model, adamw.init_state(opt_cfg, dict(model.named_parameters())),
        batch)
    for k in ("loss", "aux", "grad_norm", "lr"):
        assert float(metrics[k]) == pytest.approx(float(rmetrics[k]),
                                                  rel=TOL, abs=1e-7), k
    want = convert.params_from_reference(
        jax.tree.map(np.asarray, rparams), cfg)
    want_m = convert.params_from_reference(
        jax.tree.map(np.asarray, rstate["m"]), cfg)
    for n, p in model.named_parameters():
        assert rel(p, want[n]) <= TOL, n
        assert rel(state["m"][n], want_m[n]) <= TOL, n
