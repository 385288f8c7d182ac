"""Config-driven LM, decoder-only or encoder–decoder — the port of
``repro/models/model.py``.

The reference stacks super-blocks of one layer-kind period under
``lax.scan`` (``layer_plan``) with an unrolled tail.  The port holds
the layers in an ``nn.ModuleList`` in the reference's layer order and
runs them in a Python loop: layer ``g·period + j`` of the reference's
``blocks[j]`` at index ``g`` is ``model.layers[g·period + j]`` here,
and the tail follows (``repro_torch.models.convert`` maps one onto the
other).

Layer kinds: the attention kinds (``attn``, ``attn_local``,
``attn_global``) with a dense FFN or a Mixture-of-Experts
(``repro_torch.models.moe``; it takes precedence over ``d_ff``, as in
the reference), and the recurrent kinds — ``mamba2``
(``repro_torch.models.ssm``), ``mlstm`` and ``slstm``
(``repro_torch.models.xlstm``) — which carry no FFN.  zamba2's shared
attention block (``Model.shared_attn``, one parameter set) runs after
every full group of ``shared_attn_period`` layers, not after the tail.

An encoder–decoder (seamless-m4t-large-v2) adds ``Model.encoder``, a
stack of dense attention layers built from ``encoder_config(cfg)`` and
run without the causal mask over the encoder input (``enc_tokens``
through the shared embedding, or the frontend stub's ``enc_embeds``),
then ``enc_final_norm``; each decoder layer adds a cross-attention
block (``norm_cross``, ``cross``) between its self-attention and its
FFN, which attends over the whole encoder output with no RoPE.

Training: ``loss_fn`` is the reference's chunked next-token
cross-entropy over ``_hidden``, the undecorated body of the ``no_grad``
serving entry point ``forward_hidden``.  It computes on a
differentiable cast of the masters (``compute_params``: the
reference's ``cast_params``, whose gradient reaches the float32
masters), substituted for the parameters by
``torch.func.functional_call`` (``in_view``), and recomputes each
scanned group of layers in the backward as ``cfg.remat`` says (the
reference's ``_remat_wrap``).
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models import xlstm as XL
from repro_torch.models.layers import (
    MLP,
    Embedding,
    RMSNorm,
    normal_init_,
    param,
    softcap,
    unembed,
)
from repro_torch.models.moe import MoE, moe_apply
from repro_torch.models.partitioning import (constrain, hold, last_logsumexp,
                                              split_heads, vocab_take)


# ---------------------------------------------------------------------------
# structure helpers
# ---------------------------------------------------------------------------


def layer_plan(cfg: ModelConfig, depth: int | None = None):
    """(period, n_groups, remainder_kinds) of the reference's scan
    structure; the converter reads its parameter trees through it."""
    depth = depth if depth is not None else cfg.n_layers
    kinds = [cfg.layer_kind(i) for i in range(depth)]
    if cfg.shared_attn_period:
        period = cfg.shared_attn_period
    else:
        period = 1
        for p in range(1, len(set(kinds)) * 4 + 1):
            if all(kinds[i] == kinds[i % p] for i in range(depth)):
                period = p
                break
    n_groups = depth // period
    return period, n_groups, kinds[n_groups * period:]


def shared_groups(cfg: ModelConfig) -> dict[int, int]:
    """``{layer index: group}``: the shared attention block runs after
    the last layer of every full group of ``shared_attn_period`` layers
    (zamba2-7b: after layers 5, 11, …, 77; not after the tail of 3).
    Empty without a shared block."""
    if not cfg.shared_attn_period:
        return {}
    period, n_groups, _ = layer_plan(cfg)
    return {g * period + period - 1: g for g in range(n_groups)}


def dims(cfg: ModelConfig) -> A.AttnDims:
    return A.AttnDims(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's configuration: every layer ``"attn"`` with the
    dense ``mlp`` of ``d_ff`` (no MoE, no layer pattern, no shared
    block), as the reference builds and runs its encoder."""
    return dataclasses.replace(cfg, moe=None, block_pattern=None,
                               local_global_period=None,
                               shared_attn_period=0)


class DecoderLayer(nn.Module):
    """norm1 → attention → residual; with ``cross``, norm_cross →
    cross-attention over the encoder output → residual; then norm2 →
    MoE or MLP → residual.  The cross block never has QKV biases or QK
    norms, whatever the configuration says (the reference builds it
    with ``attn_init``'s defaults)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None,
                 dtype=torch.float32, router_dtype=torch.float32,
                 cross: bool = False):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.norm1 = RMSNorm(d, cfg.norm_eps, device, dtype)
        self.attn = A.Attention(d, dims(cfg), cfg.qkv_bias, cfg.qk_norm,
                                device, dtype)
        self.norm_cross = self.cross = None
        if cross:
            self.norm_cross = RMSNorm(d, cfg.norm_eps, device, dtype)
            self.cross = A.Attention(d, dims(cfg), False, False, device,
                                     dtype)
        self.norm2 = self.mlp = self.moe = None
        if cfg.moe is not None or cfg.d_ff:
            self.norm2 = RMSNorm(d, cfg.norm_eps, device, dtype)
        if cfg.moe is not None:
            self.moe = MoE(d, cfg.moe, cfg.activation, device, dtype,
                           router_dtype)
        elif cfg.d_ff:
            self.mlp = MLP(d, cfg.d_ff, cfg.activation, device, dtype)

    def init_(self, generator, dtype=None) -> None:
        self.norm1.init_()
        self.attn.init_(generator, dtype)
        if self.cross is not None:
            self.norm_cross.init_()
            self.cross.init_(generator, dtype)
        ffn = self.moe if self.moe is not None else self.mlp
        if ffn is not None:
            self.norm2.init_()
            ffn.init_(generator, dtype)


class RecurrentLayer(nn.Module):
    """norm1 → ``mamba`` (Mamba2), ``mlstm`` or ``slstm`` → residual; no
    FFN (zamba2's mamba layers and the xLSTM blocks carry none)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None,
                 dtype=torch.float32, f32_dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.norm1 = RMSNorm(d, cfg.norm_eps, device, dtype)
        self.mamba = self.mlstm = self.slstm = None
        if kind == "mamba2":
            self.mamba = SSM.Mamba2(d, cfg.ssm_state, cfg.ssm_head_dim,
                                    device, dtype, f32_dtype)
        elif kind == "mlstm":
            self.mlstm = XL.MLSTM(d, cfg.n_heads, device, dtype, f32_dtype)
        elif kind == "slstm":
            self.slstm = XL.SLSTM(d, cfg.n_heads, device, dtype, f32_dtype)
        else:
            raise ValueError(kind)

    @property
    def mixer(self) -> nn.Module:
        return self.mamba or self.mlstm or self.slstm

    def init_(self, generator, dtype=None) -> None:
        self.norm1.init_()
        self.mixer.init_(generator, dtype)


def make_layer(cfg: ModelConfig, kind: str, device=None, dtype=torch.float32,
               f32_dtype=torch.float32) -> nn.Module:
    if kind.startswith("attn"):
        return DecoderLayer(cfg, kind, device, dtype, f32_dtype,
                            cross=cfg.is_enc_dec)
    return RecurrentLayer(cfg, kind, device, dtype, f32_dtype)


class Model(nn.Module):
    """The port's parameter tree: ``embed.table``, ``final_norm.scale``,
    ``layers.<i>.{norm1,attn,norm2,mlp|moe}.*`` (an encoder–decoder's
    with ``norm_cross``, ``cross``) or
    ``layers.<i>.{norm1,mamba|mlstm|slstm}.*``, zamba2's
    ``shared_attn.{norm1,attn,norm2,mlp}.*``, an encoder–decoder's
    ``encoder.<i>.{norm1,attn,norm2,mlp}.*`` and
    ``enc_final_norm.scale``, and, untied, ``lm_head.w``.
    Construction allocates uninitialised parameters (``device="meta"``
    allocates none); ``init_params`` draws them.  Without ``dtype`` they
    are the masters, in ``cfg.param_dtype`` with the MoE routers and the
    recurrent blocks' ``A_log``, ``D``, ``dt_bias`` and ``fbias`` in
    float32 (the reference's initialisers); with it, every parameter has
    that dtype (a served copy)."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=None):
        super().__init__()
        f32_dtype = dtype or torch.float32
        dtype = dtype or getattr(torch, cfg.param_dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab_size, cfg.d_model, device, dtype)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device, dtype)
        self.layers = nn.ModuleList(
            make_layer(cfg, cfg.layer_kind(i), device, dtype, f32_dtype)
            for i in range(cfg.n_layers))
        self.shared_attn = (
            DecoderLayer(cfg, "attn", device, dtype, f32_dtype)
            if cfg.shared_attn_period else None)
        self.encoder = self.enc_final_norm = None
        if cfg.is_enc_dec:
            enc = encoder_config(cfg)
            self.encoder = nn.ModuleList(
                DecoderLayer(enc, enc.layer_kind(i), device, dtype)
                for i in range(cfg.encoder_layers))
            self.enc_final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device,
                                          dtype)
        self.lm_head = None
        if not cfg.tie_embeddings:
            self.lm_head = nn.ParameterDict(
                {"w": param((cfg.d_model, cfg.vocab_size), device, dtype)})

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.table.dtype

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def forward(self, fn, *args):
        """``fn(*args)``: the call through which ``functional_call`` runs
        this file's functions (``in_view``) on substituted parameters.
        The entry points are the module-level functions, not this."""
        return fn(*args)


def cast_params(model: Model, dtype) -> Model:
    """Compute-dtype copy of the (float32 master) parameters for serving:
    ``model`` itself where every floating parameter already has
    ``dtype``, else a new ``Model`` holding cast copies, detached from
    the masters (training casts through ``compute_params`` instead).  A
    server casts once when it loads the model and keeps that copy (the
    reference casts inside every jitted call, which XLA sees once; done
    eagerly per decode step at full width it would read and allocate
    the whole model a token)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if all(p.dtype == dt for p in model.parameters() if p.is_floating_point()):
        return model
    out = Model(model.cfg, device="meta")
    out.load_state_dict(
        {k: v.to(dt) if v.is_floating_point() else v
         for k, v in model.state_dict().items()}, assign=True)
    return out


def compute_params(model: Model, dtype) -> dict:
    """The reference's ``cast_params`` for training: ``{name: p.to(dtype)}``
    for each floating parameter of another dtype, whose gradient flows
    back to the master.  Integer and already-``dtype`` leaves are left
    out and read as the parameters themselves."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return {n: p.to(dt) for n, p in model.named_parameters()
            if p.is_floating_point() and p.dtype != dt}


def in_view(model: Model, params: dict, fn, *args):
    """``fn(*args)`` while each parameter of ``model`` named in ``params``
    reads as the tensor given there (``torch.func.functional_call``)."""
    if not params:
        return fn(*args)
    return functional_call(model, params, (fn, *args))


def _save_products(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the outputs of matrix products without
    batch dimensions (``x @ W``; the reference's
    ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat(fn, model: Model, modules, mode: str):
    """``fn`` recomputed in the backward as ``mode`` (``cfg.remat``)
    says while autograd records: ``"full"`` saves only the inputs,
    ``"dots"`` also the matrix products' outputs, ``"none"`` everything.
    The parameter tensors that ``fn`` reads from ``modules`` ((name
    prefix, submodule of ``model``) pairs; under ``in_view``, the casts)
    go to the checkpoint as inputs and are substituted again for the
    recompute, so it reads what the forward read."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn
    if mode not in ("full", "dots"):
        raise ValueError(f"remat must be full, dots or none, got {mode!r}")
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _save_products)
                  if mode == "dots" else None)
    kw = {"context_fn": context_fn} if context_fn else {}

    def rerun(names, n_args, *args):
        return in_view(model, dict(zip(names, args[n_args:])), fn,
                       *args[:n_args])

    def call(*args):
        named = [(f"{pre}.{n}", p) for pre, mod in modules
                 for n, p in mod.named_parameters()]
        return checkpoint(rerun, [n for n, _ in named], len(args), *args,
                          *(p for _, p in named), use_reentrant=False,
                          preserve_rng_state=False, **kw)

    return call


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, dtype=None) -> Model:
    """The masters (``cfg.param_dtype``, MoE routers and the recurrent
    blocks' constant leaves in float32) drawn from ``generator`` on
    ``device`` (``None`` is the GPU and raises without one; the
    generator must live there too): the reference's initialisers'
    distributions — truncated normal on [-2, 2] over √fan_in (the
    experts' over d and f; ``conv_w`` at std 0.5, the mLSTM ``gates`` at
    0.01; the cross-attention projections over d), the embedding at std
    d^-½, norms (``enc_final_norm`` too) and biases zero — not their
    values.  The constant leaves take the reference's values: ``A_log``
    log(linspace(1, 16, H)), ``D`` 1, ``dt_bias`` 0, ``fbias`` 3.

    With ``dtype``, every parameter is allocated in it and drawn in its
    master dtype, one parameter at a time, then cast: the values equal
    ``cast_params(init_params(cfg, generator, device), dtype)`` without
    a master copy of the whole model."""
    device = resolve_device(device)
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    master = getattr(torch, cfg.param_dtype)
    model = Model(cfg, device=device, dtype=dtype)
    model.embed.init_(generator, master)
    for layer in model.layers:
        layer.init_(generator, master)
    if model.shared_attn is not None:
        model.shared_attn.init_(generator, master)
    if model.encoder is not None:
        for layer in model.encoder:
            layer.init_(generator, master)
        model.enc_final_norm.init_()
    model.final_norm.init_()
    if model.lm_head is not None:
        normal_init_(model.lm_head["w"], generator, dtype=master)
    return model


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def ffn_sublayer(layer: DecoderLayer, cfg: ModelConfig, x):
    """norm2 → the layer's MoE or MLP → residual -> (x, the MoE's aux,
    or None)."""
    if layer.moe is not None:
        y, aux = moe_apply(layer.moe, layer.norm2(x), cfg.moe,
                           cfg.activation)
        return x + y, aux
    if layer.mlp is not None:
        x = x + layer.mlp(layer.norm2(x))
    return x, None


def cross_attention(layer: DecoderLayer, x, ck, cv,
                    q_chunk: int | None = None):
    """The cross block: norm_cross → queries from ``cross.wq`` (no RoPE,
    no bias, no norm) over the encoder's keys/values ``ck``/``cv``
    (B, S_enc, KV, hd) → ``cross.wo`` → residual.  Over a sequence
    (``q_chunk``) the flash tiles cover every encoder position; for one
    token (``q_chunk=None``) the decode attention does."""
    b, s = x.shape[:2]
    h, _, hd = layer.cross.dims
    q = split_heads(layer.norm_cross(x) @ layer.cross.wq, h, hd)
    if q_chunk is None:
        out = A.decode_attention(q, ck, cv, ck.shape[1] - 1)
    else:
        out = A.flash_attention(q, ck, cv, causal=False, q_chunk=q_chunk,
                                kv_chunk=q_chunk)
    # pinned to the batch as the self-attention's output is: DTensor
    # would reduce wo's pending sum by scattering the sequence
    return constrain(x + out.reshape(b, s, -1) @ layer.cross.wo,
                     ("batch", None, None))


def cross_kv(layer: DecoderLayer, enc_out):
    """The encoder output's keys and values for one decoder layer's cross
    block -> (ck, cv), each (B, S_enc, KV, hd)."""
    _, kv_h, hd = layer.cross.dims
    return (split_heads(enc_out @ layer.cross.wk, kv_h, hd),
            split_heads(enc_out @ layer.cross.wv, kv_h, hd))


def attn_sublayer(layer: DecoderLayer, cfg: ModelConfig, x, positions,
                  q_chunk: int, causal: bool = True, enc_out=None):
    """One layer over a whole sequence -> (x, its cache entry: k, v
    (roped) and, with a cross block, ck, cv; aux the MoE's, or None)."""
    h = layer.norm1(x)
    q, k, v = A.qkv(layer.attn, h, positions, cfg.rope_theta)
    window = cfg.sliding_window if layer.kind == "attn_local" else None
    out = A.flash_attention(q, k, v, causal=causal, window=window,
                            q_chunk=q_chunk, kv_chunk=q_chunk, merged=True)
    x = constrain(x + out @ layer.attn.wo, ("batch", None, None))
    entry = {"k": k, "v": v}
    if layer.cross is not None:
        entry["ck"], entry["cv"] = cross_kv(layer, enc_out)
        x = cross_attention(layer, x, entry["ck"], entry["cv"], q_chunk)
    x, aux = ffn_sublayer(layer, cfg, x)
    return x, entry, aux


def recurrent_sublayer(layer: RecurrentLayer, x):
    """One recurrent layer over a whole sequence -> (x, its final state
    as a cache entry: ``state``/``conv`` (the conv tail, in ``x``'s
    dtype), ``c``/``n``/``m`` or ``c``/``n``/``h``/``m``)."""
    h = layer.norm1(x)
    if layer.kind == "mamba2":
        y, state, conv = SSM.mamba2_apply(layer.mamba, h)
        return x + y, {"state": state, "conv": conv}
    if layer.kind == "mlstm":
        y, state = XL.mlstm_apply(layer.mlstm, h)
        return x + y, dict(zip("cnm", state))
    y, state = XL.slstm_apply(layer.slstm, h)
    return x + y, dict(zip("cnhm", state))


def embed_inputs(model: Model, tokens=None, embeds=None) -> torch.Tensor:
    """The residual stream's input in the activation dtype: the scaled
    token embedding, or ``embeds`` (the modality-frontend stub)."""
    adt = getattr(torch, model.cfg.activation_dtype)
    if embeds is None:
        return model.embed(tokens).to(adt)
    return embeds.to(adt)


def logits_of(model: Model, x: torch.Tensor) -> torch.Tensor:
    """Final-normed hidden states -> float32 (soft-capped) logits."""
    if model.lm_head is None:
        logits = unembed(model.embed.table, x)
    else:
        logits = x @ model.lm_head["w"]
    logits = constrain(logits, ("batch", None, "model"))
    return softcap(logits.float(), model.cfg.logit_softcap)


def encode(model: Model, enc_tokens=None, enc_embeds=None,
           q_chunk: int = 1024) -> torch.Tensor:
    """The encoder stack over ``enc_tokens`` (through the shared
    embedding) or ``enc_embeds`` (B, S_enc, D), the audio frontend stub:
    non-causal self-attention at positions 0…S_enc-1, then
    ``enc_final_norm`` -> enc_out (B, S_enc, D).  Either input is
    required (``ValueError``)."""
    if enc_tokens is None and enc_embeds is None:
        raise ValueError(f"{model.cfg.name} is an encoder-decoder: pass "
                         "enc_tokens or enc_embeds")
    enc = encoder_config(model.cfg)
    x = embed_inputs(model, enc_tokens, enc_embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, _ = run_stack(model, enc, "encoder", x, positions, q_chunk,
                     causal=False)
    return model.enc_final_norm(x)


def _layer_fwd(layer, cfg: ModelConfig, x, positions, q_chunk: int,
               causal: bool, enc_out):
    """One layer over a whole sequence -> (x, its MoE aux or None).  The
    output is pinned to the batch sharding under a policy: DTensor would
    otherwise reduce the FFN's pending sum by scattering the sequence
    over "model", which the next flattening of (B, S) cannot place."""
    if isinstance(layer, RecurrentLayer):
        x = recurrent_sublayer(layer, x)[0]
        return constrain(x, ("batch", None, None)), None
    x, _, aux = attn_sublayer(layer, cfg, x, positions, q_chunk, causal,
                              enc_out)
    return constrain(x, ("batch", None, None)), aux


def run_stack(model: Model, cfg: ModelConfig, stack: str, x, positions,
              q_chunk: int, *, causal: bool = True, enc_out=None):
    """The reference's ``_run_stack`` over ``model``'s ``stack``
    (``"layers"`` or ``"encoder"``, one module a layer, in order) ->
    (x, aux): ``layer_plan``'s groups of ``period`` layers, each followed
    by zamba2's shared block and recomputed in the backward as
    ``cfg.remat`` says (``remat``), then the tail layers, never
    recomputed.  aux is the MoE layers' sum (``None`` without MoE)."""
    layers = getattr(model, stack)
    shared = model.shared_attn if stack == "layers" else None
    period, n_groups, _ = layer_plan(cfg, len(layers))
    auxs = []

    def group(g):
        idx = range(g * period, (g + 1) * period)

        def run(x, enc_out):
            x = constrain(x, ("batch", None, None))
            aux = None
            for i in idx:
                x, a = _layer_fwd(layers[i], cfg, x, positions, q_chunk,
                                  causal, enc_out)
                if a is not None:
                    aux = a if aux is None else aux + a
            if shared is not None:
                x, _ = _layer_fwd(shared, cfg, x, positions, q_chunk, causal,
                                  None)
            return x, aux

        modules = [(f"{stack}.{i}", layers[i]) for i in idx]
        if shared is not None:
            modules.append(("shared_attn", shared))
        return remat(run, model, modules, cfg.remat)

    for g in range(n_groups):
        x, aux = group(g)(x, enc_out)
        if aux is not None:
            auxs.append(aux)
    for layer in layers[n_groups * period:]:
        x, aux = _layer_fwd(layer, cfg, x, positions, q_chunk, causal,
                            enc_out)
        if aux is not None:
            auxs.append(aux)
    return x, functools.reduce(torch.add, auxs) if auxs else None


def _hidden(model: Model, tokens, embeds, enc_tokens, enc_embeds,
            q_chunk: int):
    """The forward up to (and including) the final norm -> (x, aux), on
    parameters already in the activation dtype (a ``cast_params`` copy,
    or the masters under ``in_view`` of ``compute_params``)."""
    cfg = model.cfg
    enc_out = (encode(model, enc_tokens, enc_embeds, q_chunk)
               if cfg.is_enc_dec else None)
    x = embed_inputs(model, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = run_stack(model, cfg, "layers", x, positions, q_chunk,
                       enc_out=enc_out)
    if aux is None:
        aux = torch.zeros((), device=x.device)
    return model.final_norm(x), aux


@torch.no_grad()
def forward_hidden(model: Model, tokens=None, *, embeds=None,
                   enc_tokens=None, enc_embeds=None, q_chunk: int = 1024):
    """Forward pass up to (and including) the final norm -> (x, aux),
    aux the sum of the layers' MoE auxiliaries (0 without MoE).  An
    encoder–decoder takes ``enc_tokens`` or ``enc_embeds``."""
    return _hidden(cast_params(model, model.cfg.activation_dtype), tokens,
                   embeds, enc_tokens, enc_embeds, q_chunk)


@torch.no_grad()
def forward(model: Model, tokens=None, *, embeds=None, enc_tokens=None,
            enc_embeds=None, q_chunk: int = 1024):
    """Full forward pass -> (float32 logits (B, S, V), aux).  ``embeds``
    bypasses the token embedding; an encoder–decoder takes its encoder
    input as ``enc_tokens`` or ``enc_embeds`` (B, S_enc, D).  ``aux`` is
    the MoE load-balancing loss of the reference, summed over the layers
    (0 without MoE)."""
    model = cast_params(model, model.cfg.activation_dtype)
    x, aux = _hidden(model, tokens, embeds, enc_tokens, enc_embeds, q_chunk)
    return logits_of(model, x), aux


# ---------------------------------------------------------------------------
# training loss
# ---------------------------------------------------------------------------


def _chunk_nll(xc, lc, w, tied: bool, cap):
    """One sequence chunk's summed next-token NLL over the labels ``>= 0``
    and their count.  ``torch.gather`` refuses the label -1 that
    ``jnp.take_along_axis`` reads, so it gathers at ``max(label, 0)``;
    the mask zeroes those terms."""
    logits = constrain(xc @ (w.T if tied else w), ("batch", None, "model"))
    logits = softcap(logits.float(), cap)
    lse = last_logsumexp(logits)
    gold = vocab_take(logits, lc.clamp(min=0).long(), -1,
                      lambda t, i: t.gather(-1, i[..., None])[..., 0])
    mask = (lc >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def loss_fn(model: Model, batch: dict, q_chunk: int = 1024,
            ce_chunk: int = 256):
    """Next-token cross-entropy (+ 0.01 × the MoE aux) -> (loss, metrics
    ``loss`` and ``aux``, detached), differentiable with respect to the
    masters: the reference's ``loss_fn``.  ``batch`` holds ``labels``
    (B, S) (-1: no loss) and ``tokens`` or ``embeds``, and for an
    encoder–decoder ``enc_tokens`` or ``enc_embeds``.  The float32
    (soft-capped) logits are made ``ce_chunk`` positions at a time (one
    chunk where ``ce_chunk`` does not divide S), each chunk recomputed
    in the backward, so the (B, S, V) logits never exist at once."""
    cfg = model.cfg
    tied = model.lm_head is None

    def body():
        x, aux = _hidden(model, batch.get("tokens"), batch.get("embeds"),
                         batch.get("enc_tokens"), batch.get("enc_embeds"),
                         q_chunk)
        return x, aux, model.embed.table if tied else model.lm_head["w"]

    x, aux, w = in_view(model, compute_params(model, cfg.activation_dtype),
                        body)
    if tied:   # the head's gradient reduced to the table's placements
        w = hold(w)   # before the embedding's is added to it
    # the chunks slice the sequence: keep it whole on every rank
    x = constrain(x, ("batch", None, None))
    labels = batch["labels"]
    s = x.shape[1]
    cc = min(ce_chunk, s)
    if s % cc:
        cc = s
    tot = cnt = 0
    for c0 in range(0, s, cc):
        t, c = checkpoint(_chunk_nll, x[:, c0:c0 + cc],
                          labels[:, c0:c0 + cc], w, tied, cfg.logit_softcap,
                          use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + t, cnt + c
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss + 0.01 * aux, {"loss": loss.detach(), "aux": aux.detach()}
