"""The port's language-model serving path (``repro_torch.configs``,
``repro_torch.models``, ``repro_torch.launch.serve``) against the JAX
package on the CPU.

For every reduced configuration (the attention ones gemma-2b,
gemma-7b, qwen2.5-32b, gemma3-27b, chameleon-34b; with a
Mixture-of-Experts FFN deepseek-moe-16b and arctic-480b; the recurrent
ones zamba2-7b — Mamba2 layers and the shared attention block — and
xlstm-350m; the encoder–decoder seamless-m4t-large-v2) one reference
parameter tree, its constant leaves (norm scales, QKV biases, and the
recurrent blocks' ``conv_b``, ``dt_bias``, ``D``, ``A_log`` and
``fbias``) perturbed so that they matter, goes into both packages
(``convert.params_from_reference``); the same seeded numpy prompt
(embeddings for chameleon; seamless's encoder frames, ``enc_embeds``,
too) then goes through ``forward``, ``prefill`` (logits and every
layer's captured cache entry — k/v with seamless's cross ck/cv, or the
recurrent state — mapped through the same layer order, zamba2's
shared-block k/v of each group and seamless's ``enc_out``) and three
``decode_step``s fed the reference's greedy tokens.  At S = 32 the recurrent layers scan
one chunk; ``tests/test_torch_ssm.py`` and ``tests/test_torch_xlstm.py``
hold them across several.  gemma3 (period 3: two scanned
groups and a tail of two) covers the layer order and, at ``smax`` 160
> 8 × its window of 16, the sliding-window ring buffer; qwen2.5 and
gemma3 (KV = 2) cover the GQA head grouping.  The reference's MoE mixes
batch rows that take the same (expert, slot), where the port gives each
row its own slots (``ROADMAP.md`` §3), so for the MoE configurations
the reference runs each row alone (``B = 1``, where the two agree) and
the port's batch of two is held against those rows; the forward's aux
(the load-balancing loss, a statistic of the batch) is held row by row.

Tolerances, max |port − reference| against max |reference|: 1e-4 in
float32 (the reduced configs' activation dtype; measured at most
5.6e-7 on logits and 1.3e-6 on k/v for the attention kinds, 1.1e-6 and
1.5e-6 on the recurrent ones' logits and states), 2e-2 in bfloat16
for gemma-2b, zamba2-7b and xlstm-350m reduced (measured at most
5.1e-3 for gemma-2b over its forward, prefill and three decode
steps).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.shapes import cells_for as ref_cells_for
from repro.models import decode as RD
from repro.models import model as RM
from repro_torch.configs import registry
from repro_torch.configs.shapes import cells_for
from repro_torch.launch import serve as LS
from repro_torch.models import convert
from repro_torch.models import decode as D
from repro_torch.models import model as M

ATTN_ARCHS = ("gemma-2b", "gemma-7b", "qwen2.5-32b", "gemma3-27b",
              "chameleon-34b")
MOE_ARCHS = ("deepseek-moe-16b", "arctic-480b")
REC_ARCHS = ("zamba2-7b", "xlstm-350m")
ENCDEC_ARCHS = ("seamless-m4t-large-v2",)
ARCHS = ATTN_ARCHS + MOE_ARCHS + REC_ARCHS + ENCDEC_ARCHS
#: leaves the initialisers set to constants (norm scales and biases
#: zero; the recurrent blocks' ``A_log``, ``D``, ``dt_bias``, ``fbias``)
CONSTANT = ("scale", ".bq", ".bk", ".bv", ".conv_b", ".A_log", ".D",
            ".dt_bias", ".fbias")
B, S, Q_CHUNK, STEPS = 2, 32, 16, 3
SMAX = {"gemma3-27b": 160}          # > 8 windows: the local layers ring
TOL, TOL_BF16 = 1e-4, 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread while this module runs (several pytest workers
    on one machine otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref, dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def perturbed_params(cfg, seed=0):
    """The reference's initial parameters as numpy arrays, every constant
    leaf replaced by seeded values: norm scales, biases and ``conv_b``
    (zero at init) and ``dt_bias`` around 0, ``D`` around 1, ``A_log``
    (log-linspace) and ``fbias`` (3) shifted."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, RM.init_params(cfg,
                                                     jax.random.PRNGKey(0)))
    around = {"['conv_b']": 0.0, "['dt_bias']": 0.0, "['D']": 1.0}
    shifted = {"['A_log']": 0.3, "['fbias']": 1.0}

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        leaf = name[name.rindex("["):]
        if leaf in ("['scale']", "['bq']", "['bk']", "['bv']"):
            return (0.2 * rng.standard_normal(x.shape)).astype(x.dtype)
        if leaf in around:
            return (around[leaf] + 0.3 * rng.standard_normal(x.shape)
                    ).astype(x.dtype)
        if leaf in shifted:
            return (x + shifted[leaf] * rng.standard_normal(x.shape)
                    ).astype(x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(perturb, params)


def port_model(tree, cfg):
    model = M.Model(cfg, device="meta")
    model.load_state_dict(convert.params_from_reference(tree, cfg),
                          assign=True)
    return model


def inputs(cfg):
    """The reference's and the port's prefill keywords, the same values
    (an encoder–decoder's ``enc_embeds`` of S frames too)."""
    rng = np.random.default_rng(1)
    if cfg.frontend == "vision":
        kw = {"embeds": rng.standard_normal((B, S, cfg.d_model),
                                            dtype=np.float32)}
    else:
        kw = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                     ).astype(np.int32)}
    if cfg.is_enc_dec:
        kw["enc_embeds"] = rng.standard_normal((B, S, cfg.d_model),
                                               dtype=np.float32)
    return ({k: jnp.asarray(v) for k, v in kw.items()},
            {k: torch.from_numpy(v) for k, v in kw.items()})


def reference_run(cfg) -> dict:
    """forward (logits and aux), prefill (logits, per-layer k/v and an
    encoder–decoder's ``enc_out``) and
    STEPS greedy decode steps of the reference, with the tokens it fed;
    for a MoE configuration each batch row alone, the results stacked
    (``aux`` holds one value a row)."""
    tree = perturbed_params(cfg)
    params = jax.tree.map(jnp.asarray, tree)
    rkw, tkw = inputs(cfg)
    smax = SMAX.get(cfg.name, S + 4)
    fwd = jax.jit(lambda p, kw: RM.forward(p, cfg, q_chunk=Q_CHUNK, **kw))
    pre = jax.jit(lambda p, kw: RD.prefill(p, cfg, smax=smax,
                                           q_chunk=Q_CHUNK, **kw))
    step = jax.jit(lambda p, c, t: RD.decode_step(p, cfg, c, t))

    def run(kw):
        logits, aux = fwd(params, kw)
        out = {"forward": logits, "aux": [float(aux)]}
        logits, cache = pre(params, kw)
        out.update(prefill=logits, kv=convert.reference_layers(cache, cfg),
                   shared=convert.reference_shared(cache, cfg),
                   enc_out=cache.get("enc_out"), fed=[], decode=[])
        for _ in range(STEPS):
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
            logits, cache = step(params, cache, tok)
            out["fed"].append(np.array(tok))
            out["decode"].append(np.asarray(logits))
        out["pos"] = int(cache["pos"])
        return out

    rows = ([run(rkw)] if cfg.moe is None else
            [run({k: v[i:i + 1] for k, v in rkw.items()}) for i in range(B)])

    def cat(*xs):
        return np.concatenate([np.asarray(x) for x in xs])

    if cfg.moe is None:
        out = rows[0]
    else:
        out = {"forward": cat(*(r["forward"] for r in rows)),
               "aux": [r["aux"][0] for r in rows],
               "prefill": cat(*(r["prefill"] for r in rows)),
               "kv": [{n: cat(*(r["kv"][i][n] for r in rows)) for n in "kv"}
                      for i in range(cfg.n_layers)],
               "fed": [cat(*f) for f in zip(*(r["fed"] for r in rows))],
               "decode": [cat(*d) for d in zip(*(r["decode"] for r in rows))],
               "shared": [], "enc_out": None, "pos": rows[0]["pos"]}
    out.update(tree=tree, kw=tkw, smax=smax)
    return out


@pytest.fixture(scope="module")
def reference():
    """``reference(arch, activation_dtype)`` → the reference's run, each
    computed once per module."""
    runs = {}

    def get(arch, activation_dtype="float32"):
        if (arch, activation_dtype) not in runs:
            cfg = dataclasses.replace(ref_registry.get_reduced(arch),
                                      activation_dtype=activation_dtype)
            runs[arch, activation_dtype] = reference_run(cfg)
        return runs[arch, activation_dtype]

    return get


def port_cfg(arch, activation_dtype="float32"):
    return dataclasses.replace(registry.get_reduced(arch),
                               activation_dtype=activation_dtype)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ref_registry.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    assert registry.ARCH_IDS == ref_registry.ARCH_IDS
    for get, ref_get in ((registry.get_config, ref_registry.get_config),
                         (registry.get_reduced, ref_registry.get_reduced)):
        cfg, ref = get(arch), ref_get(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        assert cfg.param_count() == ref.param_count()
        assert cfg.active_param_count() == ref.active_param_count()
        assert cells_for(cfg) == ref_cells_for(ref)
        assert ([cfg.layer_kind(i) for i in range(cfg.n_layers)]
                == [ref.layer_kind(i) for i in range(ref.n_layers)])
        assert M.layer_plan(cfg) == RM.layer_plan(ref)


def test_gemma_2b_is_the_slices_model():
    cfg = registry.get_config("gemma-2b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
        18, 2048, 8, 1, 256, 16384, 256_000)
    assert cfg.param_count() == 2_506_096_640


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(arch, reference):
    ref = reference(arch)
    cfg = port_cfg(arch)
    model = port_model(ref["tree"], cfg)
    logits, aux = M.forward(model, q_chunk=Q_CHUNK, **ref["kw"])
    assert rel_err(logits, ref["forward"]) <= TOL
    if cfg.moe is None:
        assert float(aux) == 0.0 == ref["aux"][0]
        return
    for i, want in enumerate(ref["aux"]):
        _, aux = M.forward(model, q_chunk=Q_CHUNK,
                           **{k: v[i:i + 1] for k, v in ref["kw"].items()})
        assert abs(float(aux) - want) <= TOL * abs(want), i


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_every_layers_kv_equal_reference(arch, reference):
    """Logits, every layer's entry (k/v and seamless's cross ck/cv, or
    each leaf of the recurrent state), zamba2's shared-block k/v of each
    group and seamless's ``enc_out``."""
    ref = reference(arch)
    cfg = port_cfg(arch)
    logits, cache = D.prefill(port_model(ref["tree"], cfg), smax=ref["smax"],
                              q_chunk=Q_CHUNK, **ref["kw"])
    assert rel_err(logits, ref["prefill"]) <= TOL
    assert cache["pos"] == S
    assert len(cache["layers"]) == len(ref["kv"]) == cfg.n_layers
    for i, (got, want) in enumerate(zip(cache["layers"], ref["kv"])):
        assert got.keys() == want.keys(), i
        for name in want:
            assert str(got[name].dtype) == "torch." + str(want[name].dtype)
            assert rel_err(got[name], want[name]) <= TOL, (i, name)
    assert len(cache.get("shared", [])) == len(ref["shared"])
    for g, (got, want) in enumerate(zip(cache.get("shared", []),
                                        ref["shared"])):
        for name in "kv":
            assert rel_err(got[name], want[name]) <= TOL, (g, name)
    assert ("enc_out" in cache) == (ref["enc_out"] is not None)
    if cfg.is_enc_dec:
        assert rel_err(cache["enc_out"], ref["enc_out"]) <= TOL
    if cfg.sliding_window:      # gemma3: the local layers hold a ring
        slots = [e["k"].shape[1] for e in cache["layers"]]
        assert slots == [16, 16, 160, 16, 16, 160, 16, 16]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_equal_reference(arch, reference):
    ref = reference(arch)
    cfg = port_cfg(arch)
    model = port_model(ref["tree"], cfg)
    _, cache = D.prefill(model, smax=ref["smax"], q_chunk=Q_CHUNK,
                         **ref["kw"])
    for tok, want in zip(ref["fed"], ref["decode"]):
        logits, cache = D.decode_step(model, cache, torch.from_numpy(tok))
        assert rel_err(logits, want) <= TOL
    assert cache["pos"] == ref["pos"] == S + STEPS


def test_bfloat16_activations_equal_reference_within_tolerance(reference):
    """gemma-2b reduced with bfloat16 activations over float32 masters:
    the port casts them as the reference does, rounding at the same
    points (√d in bfloat16, scores to float32, p to bfloat16, ...).

    (The MoE layer's bfloat16 is held in ``tests/test_torch_moe.py`` on
    one input: through a whole model, rounding that differs in the last
    bfloat16 bit flips an expert where two router probabilities nearly
    tie — the reference's own jitted and op-by-op forwards of reduced
    deepseek-moe-16b differ by 0.169 of max |logits| at one token.)"""
    ref = reference("gemma-2b", "bfloat16")
    cfg = port_cfg("gemma-2b", "bfloat16")
    model = port_model(ref["tree"], cfg)
    assert model.dtype == torch.float32
    logits, _ = M.forward(model, q_chunk=Q_CHUNK, **ref["kw"])
    errs = [rel_err(logits, ref["forward"])]
    served = M.cast_params(model, cfg.activation_dtype)
    logits, cache = D.prefill(served, smax=ref["smax"], q_chunk=Q_CHUNK,
                              **ref["kw"])
    errs.append(rel_err(logits, ref["prefill"]))
    assert cache["layers"][0]["k"].dtype == torch.bfloat16
    for tok, want in zip(ref["fed"], ref["decode"]):
        logits, cache = D.decode_step(served, cache, torch.from_numpy(tok))
        errs.append(rel_err(logits, want))
    assert max(errs) <= TOL_BF16, errs


def test_bfloat16_xlstm_stack_equals_reference_within_tolerance(reference):
    """xlstm-350m reduced with bfloat16 activations (measured 1.2e-2):
    the states stay float32.

    (zamba2-7b's bfloat16 is held at the layer, in
    ``tests/test_torch_ssm.py``: through its 5 reduced layers and 2
    shared blocks the rounding noise grows to 4.7e-2 of max |logits|
    against the reference's jitted forward, whose own op-by-op forward
    differs from it by 2.0e-2; layer by layer the port is no further
    from float32 than the op-by-op reference.)"""
    ref = reference("xlstm-350m", "bfloat16")
    cfg = port_cfg("xlstm-350m", "bfloat16")
    model = port_model(ref["tree"], cfg)
    logits, _ = M.forward(model, q_chunk=Q_CHUNK, **ref["kw"])
    errs = [rel_err(logits, ref["forward"])]
    served = M.cast_params(model, cfg.activation_dtype)
    logits, cache = D.prefill(served, smax=ref["smax"], q_chunk=Q_CHUNK,
                              **ref["kw"])
    errs.append(rel_err(logits, ref["prefill"]))
    for got, want in zip(cache["layers"], ref["kv"]):
        assert {n: str(t.dtype) for n, t in got.items()} == {
            n: "torch." + str(t.dtype) for n, t in want.items()}
    for tok, want in zip(ref["fed"], ref["decode"]):
        logits, cache = D.decode_step(served, cache, torch.from_numpy(tok))
        errs.append(rel_err(logits, want))
    assert max(errs) <= TOL_BF16, errs


@pytest.mark.parametrize("arch", REC_ARCHS)
def test_cast_params_casts_the_recurrent_constants(arch):
    """The served copy casts every floating leaf — ``A_log``, ``D``,
    ``dt_bias`` and ``fbias`` too, as the reference's ``cast_params``
    does — and the masters keep them in float32."""
    cfg = dataclasses.replace(registry.get_reduced(arch),
                              param_dtype="bfloat16")
    masters = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    names = [n for n, _ in masters.named_parameters()
             if n.endswith((".A_log", ".D", ".dt_bias", ".fbias"))]
    assert len(names) == (15 if arch == "zamba2-7b" else 4)
    assert all(masters.get_parameter(n).dtype == torch.float32
               for n in names)
    served = M.cast_params(masters, "bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in served.parameters())
    for n in names:
        assert torch.equal(served.get_parameter(n),
                           masters.get_parameter(n).to(torch.bfloat16))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_reference(arch):
    """Every entry's leaves, shapes and dtypes (and zamba2's shared
    entries, one a group; seamless's cross ck/cv and ``enc_out`` over
    ``enc_len`` frames); zeros, but for an empty memory's ``m``."""
    cfg, ref_cfg = registry.get_reduced(arch), ref_registry.get_reduced(arch)
    smax = SMAX.get(arch, S + 4)
    cache = D.init_cache(cfg, B, smax, device="cpu", enc_len=S - 3)
    ref = RD.init_cache(ref_cfg, B, smax, S - 3)
    assert cache["pos"] == 0
    assert cache.keys() - {"layers", "shared"} == ref.keys() - {"blocks",
                                                                "tail"}
    if cfg.is_enc_dec:
        assert cache["enc_out"].dtype == torch.float32
        assert np.array_equal(cache["enc_out"].numpy(), ref["enc_out"])
    for got, want in ((cache["layers"], convert.reference_layers(ref, cfg)),
                      (cache.get("shared", []),
                       convert.reference_shared(ref, cfg))):
        assert [{n: (tuple(t.shape), str(t.dtype)) for n, t in e.items()}
                for e in got] == [
            {n: (t.shape, "torch." + str(t.dtype)) for n, t in w.items()}
            for w in want]
        for e, w in zip(got, want):
            for n, t in e.items():
                assert np.array_equal(t.numpy(), np.asarray(w[n])), n
    assert len(cache.get("shared", [])) == (2 if cfg.shared_attn_period
                                            else 0)


def test_decode_past_smax_raises():
    """The reference's ``dynamic_update_slice`` clamps a write at
    ``pos >= smax`` onto the last slot; the port refuses it, and leaves
    the cache as it was."""
    cfg = registry.get_reduced("gemma3-27b")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 20), dtype=torch.long)
    logits, cache = D.prefill(model, tokens, smax=21, q_chunk=16)
    logits, cache = D.decode_step(model, cache, logits.argmax(-1))
    assert cache["pos"] == 21
    before = [e["k"].clone() for e in cache["layers"]]
    with pytest.raises(ValueError, match="past the cache's smax 21"):
        D.decode_step(model, cache, logits.argmax(-1))
    assert cache["pos"] == 21
    assert all(torch.equal(a, e["k"]) for a, e in zip(before,
                                                      cache["layers"]))
    with pytest.raises(ValueError, match="shorter than the prompt"):
        D.prefill(model, tokens, smax=19, q_chunk=16)


def test_shared_block_is_one_parameter_set_with_a_cache_a_group():
    """zamba2-7b reduced (5 layers, period 2: two groups and a tail
    layer): one set of shared weights, applied after layers 1 and 3 and
    not after the tail; one k/v cache a group, each written at every
    decode step; a write past ``smax`` in the shared caches raises."""
    cfg = registry.get_reduced("zamba2-7b")
    assert M.shared_groups(cfg) == {1: 0, 3: 1}
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shared = [n for n in model.state_dict() if n.startswith("shared_attn.")]
    assert len(shared) == 9                   # norm1, 4 attn, norm2, 3 mlp
    assert not any(".attn." in n for n in model.state_dict()
                   if n.startswith("layers."))
    tokens = torch.zeros((B, 8), dtype=torch.long)
    logits, cache = D.prefill(model, tokens, smax=10, q_chunk=8)
    assert len(cache["shared"]) == 2
    a, b = (e["k"] for e in cache["shared"])
    assert a.shape == b.shape == (B, 10, cfg.n_kv_heads, cfg.head_dim)
    assert not torch.equal(a[:, :8], b[:, :8])     # each group's own input
    for pos in (8, 9):
        logits, cache = D.decode_step(model, cache, logits.argmax(-1))
        assert all(e["k"][:, pos].any() for e in cache["shared"])
    before = [e["state"].clone() for e in cache["layers"]]
    with pytest.raises(ValueError, match="past the cache's smax 10"):
        D.decode_step(model, cache, logits.argmax(-1))
    assert cache["pos"] == 10
    assert all(torch.equal(s, e["state"])
               for s, e in zip(before, cache["layers"]))


def test_recurrent_prompt_must_fill_its_chunks():
    """A prompt longer than a chunk (128) must be a multiple of it, as in
    the reference (``--prompt-len``'s help says so)."""
    cfg = registry.get_reduced("xlstm-350m")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(AssertionError):
        D.prefill(model, torch.zeros((1, 130), dtype=torch.long))
    logits, cache = D.prefill(model, torch.zeros((1, 256), dtype=torch.long))
    assert cache["pos"] == 256 and bool(torch.isfinite(logits).all())


# ---------------------------------------------------------------------------
# init, cast, converter, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-27b", "qwen2.5-32b",
                                  "deepseek-moe-16b", "zamba2-7b",
                                  "xlstm-350m", "seamless-m4t-large-v2"])
def test_init_params_draws_the_reference_distribution(arch):
    """The drawn leaves' truncated normals; the constant leaves exactly
    the reference's values (``A_log`` the correctly rounded float32 of
    log(linspace(1, 16, H)), within 3e-7 of the reference's float32
    arithmetic: ``ROADMAP.md`` §3)."""
    cfg = registry.get_reduced(arch)
    model = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    again = M.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    ref = convert.params_from_reference(
        jax.tree.map(np.asarray, RM.init_params(
            ref_registry.get_reduced(arch), jax.random.PRNGKey(0))), cfg)
    state = model.state_dict()
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in ref.items()}
    for name, p in state.items():
        assert p.dtype == torch.float32
        assert torch.equal(p, again.state_dict()[name])
        if name.endswith(".A_log"):
            want = np.log(np.linspace(1.0, 16.0, p.shape[0]))
            assert np.array_equal(p.numpy(), want.astype(np.float32))
            assert float((p - ref[name]).abs().max()) <= 3e-7
            continue
        if name.endswith(CONSTANT):
            assert torch.equal(p, ref[name]), name
            continue
        # an expert tensor (E, d_in, d_out) scales over its d_in; the
        # sLSTM's r (H, P, 4P) over its shape[0], as the reference's
        std = (cfg.d_model ** -0.5 if name == "embed.table"
               else 0.5 if name.endswith(".conv_w")
               else 0.01 if name.endswith(".mlstm.gates")
               else p.shape[1] ** -0.5 if ".moe." in name and p.ndim == 3
               else p.shape[0] ** -0.5)
        assert float(p.abs().max()) <= 2 * std, name
        # a truncated normal on [-2, 2] has std 0.880
        assert abs(float(p.std()) / std - 0.880) < 0.05, name


def test_cast_params_casts_once_and_keeps_the_masters():
    cfg = registry.get_reduced("qwen2.5-32b")
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert M.cast_params(model, "float32") is model
    served = M.cast_params(model, "bfloat16")
    assert served is not model and served.cfg is cfg
    assert all(p.dtype == torch.bfloat16 for p in served.parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert M.cast_params(served, torch.bfloat16) is served
    for (name, a), b in zip(model.state_dict().items(),
                            served.state_dict().values()):
        assert torch.equal(a.to(torch.bfloat16), b), name


def test_converter_follows_the_reference_layer_order():
    """gemma3 reduced: 8 layers of period 3 — scanned groups 0 and 1 of
    (local, local, global), then a tail of two local layers."""
    cfg = registry.get_reduced("gemma3-27b")
    assert M.layer_plan(cfg) == (3, 2, ["attn_local", "attn_local"])
    tree = jax.tree.map(np.asarray, RM.init_params(
        ref_registry.get_reduced("gemma3-27b"), jax.random.PRNGKey(0)))
    state = convert.params_from_reference(tree, cfg)
    blocks, tail = tree["decoder"]["blocks"], tree["decoder"]["tail"]
    for i in range(cfg.n_layers):
        g, j = divmod(i, 3)
        want = (blocks[j]["attn"]["wq"][g] if g < 2
                else tail[i - 6]["attn"]["wq"])
        assert np.array_equal(state[f"layers.{i}.attn.wq"].numpy(), want)
    model = port_model(tree, cfg)
    assert [layer.kind for layer in model.layers] == [
        cfg.layer_kind(i) for i in range(8)]


def test_launcher_serves_on_the_cpu(capsys):
    """gemma-2b and, with its Mamba2 layers and shared attention block,
    zamba2-7b (reduced)."""
    for arch in ("gemma-2b", "zamba2-7b"):
        LS.main(["--arch", arch, "--reduced", "--batch", "2",
                 "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
        out = capsys.readouterr().out.splitlines()
        assert out[0] == f"arch={arch} batch=2 prompt=8 gen=4 device=cpu"
        assert out[1].startswith("prefill: ") and "ms/token" in out[1]
        assert out[2].startswith("sample token ids: [")


def test_launcher_serves_xlstm_on_the_cpu(capsys):
    LS.main(["--arch", "xlstm-350m", "--reduced", "--prompt-len", "16",
             "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=xlstm-350m batch=4 prompt=16 gen=4 device=cpu"
    assert out[1].startswith("prefill: ") and "ms/token" in out[1]
    assert out[2].startswith("sample token ids: [")


def test_launcher_serves_moe_on_the_cpu(capsys):
    LS.main(["--arch", "deepseek-moe-16b", "--reduced", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("arch=deepseek-moe-16b batch=4 prompt=32 gen=16 "
                      "device=cpu")
    assert out[1].startswith("prefill: ") and "ms/token" in out[1]
    assert out[2].startswith("sample token ids: [")


@pytest.mark.parametrize("arch, param_dtype", [
    ("gemma-2b", "float32"), ("deepseek-moe-16b", "float32"),
    ("arctic-480b", "bfloat16"), ("zamba2-7b", "float32"),
    ("xlstm-350m", "bfloat16"), ("seamless-m4t-large-v2", "float32")])
def test_load_model_equals_the_cast_masters(arch, param_dtype,
                                           monkeypatch):
    """``load_model`` allocates the served dtype and draws each parameter
    in its master dtype (float32, or arctic's bfloat16 with its routers
    in float32) into a temporary of that one parameter: bit for bit the
    masters drawn from the same seed and cast by ``cast_params``.  The
    constant leaves are set, not drawn, and cast from their float32
    values."""
    cfg = dataclasses.replace(registry.get_reduced(arch),
                              param_dtype=param_dtype,
                              activation_dtype="bfloat16")
    temps = []
    empty_like = torch.empty_like

    def spy(t, **kw):
        temps.append((tuple(t.shape), kw["dtype"]))
        return empty_like(t, **kw)

    monkeypatch.setattr(torch, "empty_like", spy)
    served = LS.load_model(cfg, "cpu", seed=5)
    monkeypatch.undo()
    masters = M.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    # one temporary a drawn parameter whose master dtype is not bfloat16
    assert sorted(temps) == sorted(
        (tuple(p.shape), p.dtype) for n, p in masters.named_parameters()
        if p.dtype != torch.bfloat16
        and not n.endswith(CONSTANT))
    want = M.cast_params(masters, torch.bfloat16).state_dict()
    got = served.state_dict()
    assert got.keys() == want.keys()
    for name, p in got.items():
        assert p.dtype == torch.bfloat16, name
        assert torch.equal(p, want[name]), name
    routers = [n for n, p in masters.named_parameters()
               if n.endswith("moe.router")]
    assert len(routers) == (2 if cfg.moe else 0)
    assert all(masters.get_parameter(n).dtype == torch.float32
               for n in routers)


def test_launcher_functions_generate_greedily():
    """``decode`` feeds each step the previous step's argmax, and its
    last logits equal ``forward`` over the prompt and the fed tokens."""
    cfg = port_cfg("chameleon-34b")
    model = LS.load_model(cfg, "cpu")
    kw = LS.prompt_inputs(cfg, B, 12, "cpu")
    assert kw["embeds"].shape == (B, 12, cfg.d_model)
    logits, cache = D.prefill(model, smax=16, q_chunk=8, **kw)
    fed, last = LS.decode(model, cache, logits.argmax(-1), 4)
    assert fed.shape == (B, 4) and cache["pos"] == 16
    assert torch.equal(fed[:, :1], logits.argmax(-1))
    tokens = LS.prompt_inputs(port_cfg("gemma-2b"), B, 12, "cpu")["tokens"]
    model = LS.load_model(port_cfg("gemma-2b"), "cpu")
    logits, cache = D.prefill(model, tokens, smax=16, q_chunk=8)
    fed, last = LS.decode(model, cache, logits.argmax(-1), 4)
    full, _ = M.forward(model, torch.cat([tokens, fed], 1), q_chunk=8)
    assert rel_err(last[:, 0], full[:, -1].numpy()) < 2e-3
