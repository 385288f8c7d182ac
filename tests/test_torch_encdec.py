"""The port's encoder–decoder (``repro_torch.models``: ``Model.encoder``,
the decoder layers' cross blocks, the ``ck``/``cv``/``enc_out`` cache,
``launch.serve``) against the JAX package on the CPU, at the reduced
seamless-m4t-large-v2 width, in the cases the model tests' common sizes
leave out:

- an encoder of 3 layers under a decoder of 2, so the converter must
  map each stack at its own depth;
- 37 encoder frames under a 32-token prompt with ``q_chunk`` 16, so the
  encoder's and the cross block's non-causal tiles pad their keys;
- the ``enc_tokens`` path beside the frontend stub's ``enc_embeds``;
- the cross block alone (a layer without an FFN) against the
  reference's ``_attn_sublayer``, ``_layer_prefill`` and
  ``_attn_decode``, in float32 and bfloat16;
- QKV biases and QK norms in the configuration, which the cross block
  never has;
- an encoder–decoder call without encoder input;
- the launcher's prompt draws and a reduced run on the CPU.

Tolerances, max |port − reference| against max |reference|: 1e-4 in
float32, 2e-2 in bfloat16 at the layer.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import serve as RLS
from repro.models import decode as RD
from repro.models import model as RM
from repro_torch.configs import registry
from repro_torch.launch import serve as LS
from repro_torch.models import convert
from repro_torch.models import decode as D
from repro_torch.models import model as M

ARCH = "seamless-m4t-large-v2"
B, S, ENC_S, ENC_LAYERS, Q_CHUNK, STEPS = 2, 32, 37, 3, 16, 3
KINDS = ("enc_embeds", "enc_tokens")
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


def configs(**kw):
    """(reference, port) reduced seamless, its encoder 3 layers deep."""
    return tuple(dataclasses.replace(r.get_reduced(ARCH),
                                     encoder_layers=ENC_LAYERS, **kw)
                 for r in (ref_registry, registry))


def reference_tree(cfg) -> dict:
    """The reference's initial parameters as numpy arrays, the norm scales
    and biases (zero at init) seeded so that they matter."""
    rng = np.random.default_rng(0)

    def perturb(path, x):
        if jax.tree_util.keystr(path).endswith(
                ("['scale']", "['bq']", "['bk']", "['bv']")):
            return (0.2 * rng.standard_normal(x.shape)).astype(x.dtype)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(
        perturb, RM.init_params(cfg, jax.random.PRNGKey(0)))


def port_model(tree, cfg) -> M.Model:
    """The reference's tree in the port, loaded strictly: no missing and
    no unexpected key."""
    model = M.Model(cfg, device="meta")
    model.load_state_dict(convert.params_from_reference(tree, cfg),
                          strict=True, assign=True)
    return model


def prompt(cfg, kind: str) -> dict:
    """A 32-token prompt and 37 encoder positions (``kind``: frames or
    tokens), as numpy arrays."""
    rng = np.random.default_rng(1)
    kw = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    kw[kind] = (rng.integers(0, cfg.vocab_size, (B, ENC_S)).astype(np.int32)
                if kind == "enc_tokens" else
                rng.standard_normal((B, ENC_S, cfg.d_model),
                                    dtype=np.float32))
    return kw


@pytest.fixture(scope="module")
def reference():
    """``reference(kind)`` → the reference's forward, prefill (logits,
    every layer's k/v/ck/cv, ``enc_out``) and STEPS greedy decode steps
    with the tokens fed, computed once per module."""
    ref_cfg, _ = configs()
    tree = reference_tree(ref_cfg)
    params = jax.tree.map(jnp.asarray, tree)
    fwd = jax.jit(lambda p, kw: RM.forward(p, ref_cfg, q_chunk=Q_CHUNK, **kw))
    pre = jax.jit(lambda p, kw: RD.prefill(p, ref_cfg, smax=S + STEPS,
                                           q_chunk=Q_CHUNK, **kw))
    step = jax.jit(lambda p, c, t: RD.decode_step(p, ref_cfg, c, t))
    runs = {}

    def get(kind):
        if kind not in runs:
            kw = prompt(ref_cfg, kind)
            rkw = {k: jnp.asarray(v) for k, v in kw.items()}
            out = {"tree": tree, "forward": np.asarray(fwd(params, rkw)[0]),
                   "kw": {k: torch.from_numpy(v) for k, v in kw.items()}}
            logits, cache = pre(params, rkw)
            out.update(prefill=np.asarray(logits),
                       layers=convert.reference_layers(cache, ref_cfg),
                       enc_out=np.asarray(cache["enc_out"]), fed=[],
                       decode=[])
            for _ in range(STEPS):
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                logits, cache = step(params, cache, tok)
                out["fed"].append(np.array(tok))
                out["decode"].append(np.asarray(logits))
            runs[kind] = out
        return runs[kind]

    return get


# ---------------------------------------------------------------------------
# unequal depths, padded non-causal keys, both encoder inputs
# ---------------------------------------------------------------------------


def test_converter_carries_every_encoder_layer(reference):
    """All 3 encoder layers, ``enc_final_norm`` and the decoder's cross
    leaves, copied as they are; read at the decoder's depth (2), the
    encoder stack is refused, not cut."""
    ref = reference("enc_embeds")
    tree = ref["tree"]
    ref_cfg, cfg = configs()
    state = convert.params_from_reference(tree, cfg)
    blocks = tree["encoder"]["blocks"][0]
    for g in range(ENC_LAYERS):
        for name in ("norm1.scale", "attn.wq", "norm2.scale", "mlp.up"):
            a, b = name.split(".")
            assert np.array_equal(state[f"encoder.{g}.{name}"].numpy(),
                                  blocks[a][b][g]), (g, name)
    assert f"encoder.{ENC_LAYERS}.attn.wq" not in state
    assert np.array_equal(state["enc_final_norm.scale"].numpy(),
                          tree["enc_final_norm"]["scale"])
    dec = tree["decoder"]["blocks"][0]
    for i in range(cfg.n_layers):
        for a, b in (("norm_cross", "scale"), ("cross", "wq"),
                     ("cross", "wo")):
            assert np.array_equal(state[f"layers.{i}.{a}.{b}"].numpy(),
                                  dec[a][b][i])
    model = port_model(tree, cfg)
    assert (len(model.encoder), len(model.layers)) == (ENC_LAYERS, 2)
    assert M.layer_plan(M.encoder_config(cfg), ENC_LAYERS) == RM.layer_plan(
        ref_cfg, ENC_LAYERS)
    with pytest.raises(ValueError, match="a depth of 2 needs 2"):
        convert.reference_layers(tree["encoder"], cfg)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_equals_reference(kind, reference):
    ref = reference(kind)
    _, cfg = configs()
    logits, aux = M.forward(port_model(ref["tree"], cfg), q_chunk=Q_CHUNK,
                            **ref["kw"])
    assert rel_err(logits, ref["forward"]) <= TOL
    assert float(aux) == 0.0


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_captures_the_cross_memory(kind, reference):
    """Logits, every layer's k/v and its cross ck/cv over all 37 encoder
    positions, and ``enc_out``."""
    ref = reference(kind)
    _, cfg = configs()
    logits, cache = D.prefill(port_model(ref["tree"], cfg), smax=S + STEPS,
                              q_chunk=Q_CHUNK, **ref["kw"])
    assert rel_err(logits, ref["prefill"]) <= TOL
    assert cache["pos"] == S
    assert len(cache["layers"]) == len(ref["layers"]) == cfg.n_layers
    for i, (got, want) in enumerate(zip(cache["layers"], ref["layers"])):
        assert got.keys() == want.keys() == {"k", "v", "ck", "cv"}, i
        assert got["ck"].shape == (B, ENC_S, cfg.n_kv_heads, cfg.head_dim)
        for name in want:
            assert rel_err(got[name], want[name]) <= TOL, (i, name)
    assert rel_err(cache["enc_out"], ref["enc_out"]) <= TOL


@pytest.mark.parametrize("kind", KINDS)
def test_decode_steps_equal_reference(kind, reference):
    ref = reference(kind)
    _, cfg = configs()
    model = port_model(ref["tree"], cfg)
    _, cache = D.prefill(model, smax=S + STEPS, q_chunk=Q_CHUNK, **ref["kw"])
    for tok, want in zip(ref["fed"], ref["decode"]):
        logits, cache = D.decode_step(model, cache, torch.from_numpy(tok))
        assert rel_err(logits, want) <= TOL
    assert cache["pos"] == S + STEPS


# ---------------------------------------------------------------------------
# the cross block alone; the flags it ignores
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_block_equals_reference(dtype):
    """One decoder layer without an FFN (self-attention, then the cross
    block) over a 32-token sequence and 37 encoder frames, its cache
    entry, and one decode step against that entry."""
    ref_cfg, cfg = configs(d_ff=0, activation_dtype=dtype)
    tree = reference_tree(ref_cfg)
    p = jax.tree.map(lambda t: jnp.asarray(t[0]),
                     tree["decoder"]["blocks"][0])
    layer = M.cast_params(port_model(tree, cfg), dtype).layers[0]
    assert layer.mlp is None and layer.moe is None
    p = RM.cast_params(p, dtype)
    rng = np.random.default_rng(2)
    x, enc_out, tok = (rng.standard_normal(shape, dtype=np.float32)
                       for shape in ((B, S, cfg.d_model),
                                     (B, ENC_S, cfg.d_model),
                                     (B, 1, cfg.d_model)))
    jx, jenc, jtok = (jnp.asarray(a, dtype) for a in (x, enc_out, tok))
    tx, tenc, ttok = (torch.from_numpy(a).to(getattr(torch, dtype))
                      for a in (x, enc_out, tok))
    positions = jnp.arange(S)[None, :]
    tol = TOL if dtype == "float32" else TOL_BF16

    want, _ = jax.jit(lambda p, x, e: RM._attn_sublayer(
        p, ref_cfg, x, "attn", positions, True, e, Q_CHUNK))(p, jx, jenc)
    _, want_entry = jax.jit(lambda p, x, e: RD._layer_prefill(
        p, ref_cfg, x, "attn", positions, e, S + 1, Q_CHUNK))(p, jx, jenc)
    with torch.no_grad():
        got, entry, _ = M.attn_sublayer(layer, cfg, tx,
                                        torch.arange(S)[None, :], Q_CHUNK,
                                        enc_out=tenc)
    assert rel_err(got, want) <= tol
    for name in ("k", "v", "ck", "cv"):
        want_t = want_entry[name][:, :S] if name in "kv" else want_entry[name]
        assert rel_err(entry[name], want_t) <= tol, name

    want, _ = jax.jit(lambda p, x, e: RD._attn_decode(
        p, ref_cfg, x, "attn", e, S))(p, jtok, want_entry)
    entry = {n: torch.from_numpy(np.array(t, np.float32)).to(tx.dtype)
             for n, t in want_entry.items()}
    with torch.no_grad():
        got = D._attn_decode(layer, cfg, ttok, entry, S,
                             torch.full((B, 1), S))
    assert rel_err(got, want) <= tol


def test_cross_block_has_no_bias_and_no_norm():
    """With ``qkv_bias`` and ``qk_norm`` set, self-attention has both and
    the cross block neither, in both packages; the forward still
    equals the reference's."""
    ref_cfg, cfg = configs(qkv_bias=True, qk_norm=True)
    tree = reference_tree(ref_cfg)
    assert set(tree["decoder"]["blocks"][0]["cross"]) == {"wq", "wk", "wv",
                                                          "wo"}
    model = port_model(tree, cfg)
    for layer in model.layers:
        assert layer.attn.bq is not None and layer.attn.q_norm is not None
        assert layer.cross.bq is None and layer.cross.q_norm is None
    kw = prompt(ref_cfg, "enc_embeds")
    want, _ = jax.jit(lambda p, kw: RM.forward(p, ref_cfg, q_chunk=Q_CHUNK,
                                               **kw))(
        jax.tree.map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in kw.items()})
    got, _ = M.forward(model, q_chunk=Q_CHUNK,
                       **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert rel_err(got, want) <= TOL


def test_encoder_decoder_needs_encoder_input():
    """The reference fails inside its embedding lookup; the port says
    what is missing."""
    _, cfg = configs()
    model = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    for call in (lambda: M.forward(model, tokens),
                 lambda: M.forward_hidden(model, tokens),
                 lambda: D.prefill(model, tokens)):
        with pytest.raises(ValueError, match="pass enc_tokens or enc_embeds"):
            call()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


class _Drawn(Exception):
    """Raised by the spy once the reference launcher has drawn its
    prompt."""


def test_prompt_inputs_draw_the_reference_launchers(monkeypatch):
    """``prompt_inputs`` gives the tokens and ``enc_embeds`` the
    reference's ``python -m repro.launch.serve`` draws for seed 0 (its
    ``prefill`` is stopped at the call)."""
    drawn = {}

    def spy(params, cfg, tokens, **kw):
        drawn.update(tokens=np.asarray(tokens),
                     enc_embeds=np.asarray(kw["enc_embeds"]))
        raise _Drawn

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--reduced",
                                      "--batch", "3", "--prompt-len", "5"])
    monkeypatch.setattr(RLS.MDL, "init_params", lambda cfg, key: None)
    monkeypatch.setattr(RLS.DEC, "prefill", spy)
    with pytest.raises(_Drawn):
        RLS.main()
    kw = LS.prompt_inputs(registry.get_reduced(ARCH), 3, 5, "cpu")
    assert kw.keys() == drawn.keys()
    for name, want in drawn.items():
        assert np.array_equal(kw[name].numpy(), want), name
    assert kw["enc_embeds"].shape == (3, 5, 64)


def test_launcher_serves_seamless_on_the_cpu(capsys):
    LS.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
             "8", "--gen", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={ARCH} batch=2 prompt=8 gen=4 device=cpu"
    assert out[1].startswith("prefill: ") and "ms/token" in out[1]
    assert out[2].startswith("sample token ids: [")
