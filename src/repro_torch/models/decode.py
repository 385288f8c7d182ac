"""Serving path: cache init, prefill (cache capture), single-token decode
— the port of ``repro/models/decode.py``.

The cache is ``{"layers": [entry, ...], "pos": int}`` and, with zamba2's
shared attention block, ``"shared"``: one ``{"k", "v"}`` entry a group
(the weights are one set; each place in the stack keeps its own cache).
``layers`` holds one entry a layer in the model's layer order
(``convert.reference_layers`` and ``convert.reference_shared`` map the
reference's scan-grouped cache onto it):

  attention : k/v (B, Smax, KV, hd) in the activation dtype; in an
              encoder–decoder also the cross block's ``ck``/``cv``
              (B, S_enc, KV, hd), the encoder output's keys and values
  mamba2    : ``state`` (B, H, P, N) float32, ``conv`` (B, K-1, conv_dim)
              in the activation dtype
  mlstm     : ``c`` (B, H, P, P), ``n`` (B, H, P), ``m`` (B, H), float32
  slstm     : ``c``, ``n``, ``h``, ``m`` (B, d), float32

An encoder–decoder's cache also holds ``enc_out`` (B, S_enc, D), as
the reference's does; decoding reads only ``ck``/``cv``.  An empty
memory's ``m`` is -1e30.  ``pos`` is a host integer, so a
decode step reads nothing back from the device.  A sliding-window layer
whose ``smax`` exceeds ``RING_THRESHOLD`` windows holds a ring of
``window`` slots instead, written at ``pos % window``.

``decode_step`` writes the new token's k/v into the cache in place,
replaces the recurrent entries' tensors with the stepped ones, and
returns the same dict.  Where the reference's ``dynamic_update_slice``
would clamp a write past ``smax`` onto the last slot, ``decode_step``
raises ``ValueError``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models import partitioning as PT
from repro_torch.models import xlstm as XL
from repro_torch.models.model import (
    Model,
    RecurrentLayer,
    attn_sublayer,
    cast_params,
    cross_attention,
    embed_inputs,
    encode,
    ffn_sublayer,
    logits_of,
    recurrent_sublayer,
    shared_groups,
)

RING_THRESHOLD = 8  # use a ring buffer when smax > threshold × window


def _ring_len(cfg: ModelConfig, kind: str, smax: int) -> int:
    """Sliding-window layers never attend further than ``window`` back,
    so past ``RING_THRESHOLD`` windows a ring of exactly ``window`` slots
    replaces the full-sequence cache (write at pos % window; the ring's
    size guarantees slot recency, so no extra masking is needed)."""
    if (kind == "attn_local" and cfg.sliding_window
            and smax > RING_THRESHOLD * cfg.sliding_window):
        return cfg.sliding_window
    return smax


def _is_ring(cfg: ModelConfig, kind: str, entry: dict) -> bool:
    return kind == "attn_local" and entry["k"].shape[1] == cfg.sliding_window


def _entry(cfg: ModelConfig, kind: str, batch: int, smax: int,
           device, enc_len: int | None = None) -> dict:
    """An empty cache entry of one layer of ``kind`` (with ``enc_len``,
    an attention layer's cross ``ck``/``cv`` too)."""
    adt = getattr(torch, cfg.activation_dtype)
    f32 = dict(dtype=torch.float32, device=device)
    if kind.startswith("attn"):
        def zeros(slen):
            return torch.zeros((batch, slen, cfg.n_kv_heads, cfg.head_dim),
                               dtype=adt, device=device)

        slen = _ring_len(cfg, kind, smax)
        entry = {"k": zeros(slen), "v": zeros(slen)}
        if enc_len is not None:
            entry.update(ck=zeros(enc_len), cv=zeros(enc_len))
        return entry
    if kind == "mamba2":
        d_in, h = SSM.ssm_dims(cfg.d_model, cfg.ssm_head_dim)
        return {"state": torch.zeros((batch, h, cfg.ssm_head_dim,
                                      cfg.ssm_state), **f32),
                "conv": torch.zeros((batch, SSM.CONV_K - 1,
                                     d_in + 2 * cfg.ssm_state),
                                    dtype=adt, device=device)}
    if kind == "mlstm":
        hp = 2 * cfg.d_model // cfg.n_heads
        return dict(zip("cnm", XL.mlstm_init_state(batch, cfg.n_heads, hp,
                                                   device)))
    if kind == "slstm":
        return dict(zip("cnhm", XL.slstm_init_state(batch, cfg.d_model,
                                                    device)))
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, smax: int,
               device=None, *, enc_len: int = 0) -> dict:
    """An empty cache at ``pos`` 0 (``device=None`` is the GPU); an
    encoder–decoder's holds ``enc_len`` encoder positions."""
    device = resolve_device(device)
    cross = enc_len if cfg.is_enc_dec else None
    cache = {"layers": [_entry(cfg, cfg.layer_kind(i), batch, smax, device,
                               cross)
                        for i in range(cfg.n_layers)], "pos": 0}
    if cfg.is_enc_dec:
        cache["enc_out"] = torch.zeros(
            (batch, enc_len, cfg.d_model),
            dtype=getattr(torch, cfg.activation_dtype), device=device)
    if cfg.shared_attn_period:
        cache["shared"] = [_entry(cfg, "attn", batch, smax, device)
                           for _ in shared_groups(cfg)]
    return cache


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------


def _attn_decode(layer, cfg: ModelConfig, x, entry: dict, pos: int,
                 positions):
    """One attention layer (or the shared block) for one token, its k/v
    written into ``entry`` at ``pos``; a cross block attends over the
    entry's ``ck``/``cv``."""
    b = x.shape[0]
    h = layer.norm1(x)
    q, k, v = A.qkv(layer.attn, h, positions, cfg.rope_theta)
    ring = _is_ring(cfg, layer.kind, entry)
    wpos = pos % cfg.sliding_window if ring else pos
    for name, new in (("k", k), ("v", v)):
        PT.write_slot(entry[name], wpos, new[:, 0])
        entry[name] = PT.constrain_cache(entry[name])
    # ring recency is structural; only pre-warm-up slots need masking,
    # which `slot <= pos` provides (always true once pos >= window)
    window = (cfg.sliding_window
              if layer.kind == "attn_local" and not ring else None)
    out = A.decode_attention(q, entry["k"], entry["v"], pos, window)
    x = x + out.reshape(b, 1, -1) @ layer.attn.wo
    if layer.cross is not None:
        x = cross_attention(layer, x, entry["ck"], entry["cv"])
    # a MoE routes the step as a chunk of one token a row
    x, _ = ffn_sublayer(layer, cfg, x)
    return x


def _recurrent_decode(layer: RecurrentLayer, x, entry: dict):
    """One recurrent layer for one token; ``entry``'s tensors are
    replaced by the stepped state."""
    h = layer.norm1(x)
    if layer.kind == "mamba2":
        y, entry["state"], entry["conv"] = SSM.mamba2_decode(
            layer.mamba, h, entry["state"], entry["conv"])
    elif layer.kind == "mlstm":
        y, state = XL.mlstm_decode(layer.mlstm, h,
                                   tuple(entry[n] for n in "cnm"))
        entry.update(zip("cnm", state))
    else:
        y, state = XL.slstm_decode(layer.slstm, h,
                                   tuple(entry[n] for n in "cnhm"))
        entry.update(zip("cnhm", state))
    return x + y


@torch.no_grad()
def decode_step(model: Model, cache: dict, tokens=None, *, embeds=None):
    """One token for every sequence in the batch.

    tokens: (B, 1) integer (or embeds (B, 1, D)).  Returns (float32
    logits (B, 1, V), cache), the cache updated in place."""
    cfg = model.cfg
    model = cast_params(model, cfg.activation_dtype)
    pos = cache["pos"]
    attn = [(layer.kind, entry)
            for layer, entry in zip(model.layers, cache["layers"])
            if not isinstance(layer, RecurrentLayer)]
    attn += [("attn", entry) for entry in cache.get("shared", [])]
    for kind, entry in attn:
        if not _is_ring(cfg, kind, entry) and pos >= entry["k"].shape[1]:
            raise ValueError(
                f"decode_step at pos {pos} would write past the cache's "
                f"smax {entry['k'].shape[1]} (the reference clamps the "
                "write onto the last slot; the port refuses)")
    x = embed_inputs(model, tokens, embeds)
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)

    shared = shared_groups(cfg)
    for i, (layer, entry) in enumerate(zip(model.layers, cache["layers"])):
        if isinstance(layer, RecurrentLayer):
            x = _recurrent_decode(layer, x, entry)
        else:
            x = _attn_decode(layer, cfg, x, entry, pos, positions)
        if i in shared:
            x = _attn_decode(model.shared_attn, cfg, x,
                             cache["shared"][shared[i]], pos, positions)

    logits = logits_of(model, model.final_norm(x))
    cache["pos"] = pos + 1
    return logits, cache


# ---------------------------------------------------------------------------
# prefill: forward pass that captures the cache
# ---------------------------------------------------------------------------


def _capture(cfg: ModelConfig, kind: str, k: torch.Tensor, smax: int):
    """A layer's cache entry for one of k/v: the last ``window``
    positions scattered into their ``pos % window`` ring slots, or the
    sequence zero-padded to ``smax``."""
    b, s = k.shape[:2]
    slen = _ring_len(cfg, kind, smax)
    out = k.new_zeros((b, slen) + k.shape[2:])
    if slen < smax:
        keep = min(slen, s)
        out[:, torch.arange(s - keep, s, device=k.device) % slen] = (
            k[:, s - keep:])
    else:
        out[:, :s] = k
    return out


@torch.no_grad()
def prefill(model: Model, tokens=None, *, embeds=None, enc_tokens=None,
            enc_embeds=None, smax: int | None = None, q_chunk: int = 1024):
    """Forward pass over the prompt; returns (float32 last-token logits
    (B, 1, V), cache at ``pos`` = prompt length).  An encoder–decoder
    runs its encoder once over ``enc_tokens`` or ``enc_embeds`` and
    keeps each layer's cross ``ck``/``cv`` and ``enc_out``."""
    cfg = model.cfg
    model = cast_params(model, cfg.activation_dtype)
    enc_out = (encode(model, enc_tokens, enc_embeds, q_chunk)
               if cfg.is_enc_dec else None)
    x = embed_inputs(model, tokens, embeds)
    s = x.shape[1]
    smax = smax or s
    if smax < s:
        raise ValueError(f"smax {smax} is shorter than the prompt ({s})")
    positions = torch.arange(s, device=x.device)[None, :]

    def capture(kind, entry):
        return {n: _capture(cfg, kind, t, smax) if n in ("k", "v") else t
                for n, t in entry.items()}

    layers: list[dict[str, Any]] = []
    shared_entries: list[dict[str, Any]] = []
    shared = shared_groups(cfg)
    for i, layer in enumerate(model.layers):
        # each layer's input on the batch sharding, as ``run_stack``'s
        x = PT.constrain(x, ("batch", None, None))
        if isinstance(layer, RecurrentLayer):
            x, entry = recurrent_sublayer(layer, x)
            layers.append(entry)
        else:
            x, entry, _ = attn_sublayer(layer, cfg, x, positions, q_chunk,
                                        enc_out=enc_out)
            layers.append(capture(layer.kind, entry))
        if i in shared:
            x, entry, _ = attn_sublayer(model.shared_attn, cfg, x, positions,
                                        q_chunk)
            shared_entries.append(capture("attn", entry))

    logits = logits_of(model, model.final_norm(x[:, -1:, :]))
    cache = {"layers": layers, "pos": s}
    if cfg.is_enc_dec:
        cache["enc_out"] = enc_out
    if cfg.shared_attn_period:
        cache["shared"] = shared_entries
    return logits, cache
