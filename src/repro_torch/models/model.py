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
``loss_fn`` waits for the training slice.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

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


def cast_params(model: Model, dtype) -> Model:
    """Compute-dtype view of the (float32 master) parameters: ``model``
    itself where every floating parameter already has ``dtype``, else a
    new ``Model`` holding cast copies.  A server casts once when it
    loads the model and keeps that copy (the reference casts inside
    every jitted call, which XLA sees once; done eagerly per decode step
    at full width it would read and allocate the whole model a
    token)."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if all(p.dtype == dt for p in model.parameters() if p.is_floating_point()):
        return model
    out = Model(model.cfg, device="meta")
    out.load_state_dict(
        {k: v.to(dt) if v.is_floating_point() else v
         for k, v in model.state_dict().items()}, assign=True)
    return out


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
    q = (layer.norm_cross(x) @ layer.cross.wq).reshape(b, s, h, hd)
    if q_chunk is None:
        out = A.decode_attention(q, ck, cv, ck.shape[1] - 1)
    else:
        out = A.flash_attention(q, ck, cv, causal=False, q_chunk=q_chunk,
                                kv_chunk=q_chunk)
    return x + out.reshape(b, s, -1) @ layer.cross.wo


def cross_kv(layer: DecoderLayer, enc_out):
    """The encoder output's keys and values for one decoder layer's cross
    block -> (ck, cv), each (B, S_enc, KV, hd)."""
    _, kv_h, hd = layer.cross.dims
    shape = enc_out.shape[:2] + (kv_h, hd)
    return ((enc_out @ layer.cross.wk).reshape(shape),
            (enc_out @ layer.cross.wv).reshape(shape))


def attn_sublayer(layer: DecoderLayer, cfg: ModelConfig, x, positions,
                  q_chunk: int, causal: bool = True, enc_out=None):
    """One layer over a whole sequence -> (x, its cache entry: k, v
    (roped) and, with a cross block, ck, cv; aux the MoE's, or None)."""
    b, s = x.shape[:2]
    h = layer.norm1(x)
    q, k, v = A.qkv(layer.attn, h, positions, cfg.rope_theta)
    window = cfg.sliding_window if layer.kind == "attn_local" else None
    out = A.flash_attention(q, k, v, causal=causal, window=window,
                            q_chunk=q_chunk, kv_chunk=q_chunk)
    x = x + out.reshape(b, s, -1) @ layer.attn.wo
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
    for layer in model.encoder:
        x, _, _ = attn_sublayer(layer, enc, x, positions, q_chunk,
                                causal=False)
    return model.enc_final_norm(x)


@torch.no_grad()
def forward_hidden(model: Model, tokens=None, *, embeds=None,
                   enc_tokens=None, enc_embeds=None, q_chunk: int = 1024):
    """Forward pass up to (and including) the final norm -> (x, aux),
    aux the sum of the layers' MoE auxiliaries (0 without MoE).  An
    encoder–decoder takes ``enc_tokens`` or ``enc_embeds``."""
    cfg = model.cfg
    model = cast_params(model, cfg.activation_dtype)
    enc_out = (encode(model, enc_tokens, enc_embeds, q_chunk)
               if cfg.is_enc_dec else None)
    x = embed_inputs(model, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), device=x.device)
    shared = shared_groups(cfg)
    for i, layer in enumerate(model.layers):
        if isinstance(layer, RecurrentLayer):
            x, _ = recurrent_sublayer(layer, x)
        else:
            x, _, layer_aux = attn_sublayer(layer, cfg, x, positions,
                                            q_chunk, enc_out=enc_out)
            if layer_aux is not None:
                aux = aux + layer_aux
        if i in shared:
            x, _, _ = attn_sublayer(model.shared_attn, cfg, x, positions,
                                    q_chunk)
    return model.final_norm(x), aux


@torch.no_grad()
def forward(model: Model, tokens=None, *, embeds=None, enc_tokens=None,
            enc_embeds=None, q_chunk: int = 1024):
    """Full forward pass -> (float32 logits (B, S, V), aux).  ``embeds``
    bypasses the token embedding; an encoder–decoder takes its encoder
    input as ``enc_tokens`` or ``enc_embeds`` (B, S_enc, D).  ``aux`` is
    the MoE load-balancing loss of the reference, summed over the layers
    (0 without MoE)."""
    model = cast_params(model, model.cfg.activation_dtype)
    x, aux = forward_hidden(model, tokens, embeds=embeds,
                            enc_tokens=enc_tokens, enc_embeds=enc_embeds,
                            q_chunk=q_chunk)
    return logits_of(model, x), aux
