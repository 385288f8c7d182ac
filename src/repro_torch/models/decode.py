"""Serving path: cache init, prefill (cache capture), single-token decode
— the port of ``repro/models/decode.py`` for the attention kinds (with
a dense or MoE FFN).

The cache is ``{"layers": [{"k", "v"}, ...], "pos": int}``: one entry a
layer in the model's layer order (``convert.reference_layers`` maps the
reference's scan-grouped cache onto it), k/v of shape (B, Smax, KV, hd)
in the activation dtype, and ``pos`` a host integer, so a decode step
reads nothing back from the device.  A sliding-window layer whose
``smax`` exceeds ``RING_THRESHOLD`` windows holds a ring of ``window``
slots instead, written at ``pos % window``.

``decode_step`` writes the new token's k/v into the cache in place and
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
from repro_torch.models.model import (
    Model,
    attn_sublayer,
    cast_params,
    check_supported,
    embed_inputs,
    ffn_sublayer,
    logits_of,
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


def init_cache(cfg: ModelConfig, batch: int, smax: int,
               device=None) -> dict:
    """An empty cache at ``pos`` 0 (``device=None`` is the GPU)."""
    check_supported(cfg)
    device = resolve_device(device)
    adt = getattr(torch, cfg.activation_dtype)
    layers = []
    for i in range(cfg.n_layers):
        shape = (batch, _ring_len(cfg, cfg.layer_kind(i), smax),
                 cfg.n_kv_heads, cfg.head_dim)
        layers.append({"k": torch.zeros(shape, dtype=adt, device=device),
                       "v": torch.zeros(shape, dtype=adt, device=device)})
    return {"layers": layers, "pos": 0}


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(model: Model, cache: dict, tokens=None, *, embeds=None):
    """One token for every sequence in the batch.

    tokens: (B, 1) integer (or embeds (B, 1, D)).  Returns (float32
    logits (B, 1, V), cache), the cache updated in place."""
    cfg = model.cfg
    model = cast_params(model, cfg.activation_dtype)
    pos = cache["pos"]
    for layer, entry in zip(model.layers, cache["layers"]):
        if not _is_ring(cfg, layer.kind, entry) and pos >= entry["k"].shape[1]:
            raise ValueError(
                f"decode_step at pos {pos} would write past the cache's "
                f"smax {entry['k'].shape[1]} (the reference clamps the "
                "write onto the last slot; the port refuses)")
    x = embed_inputs(model, tokens, embeds)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)

    for layer, entry in zip(model.layers, cache["layers"]):
        h = layer.norm1(x)
        q, k, v = A.qkv(layer.attn, h, positions, cfg.rope_theta)
        ring = _is_ring(cfg, layer.kind, entry)
        wpos = pos % cfg.sliding_window if ring else pos
        entry["k"][:, wpos] = k[:, 0]
        entry["v"][:, wpos] = v[:, 0]
        # ring recency is structural; only pre-warm-up slots need
        # masking, which `slot <= pos` provides (always true once
        # pos >= window)
        window = (cfg.sliding_window
                  if layer.kind == "attn_local" and not ring else None)
        out = A.decode_attention(q, entry["k"], entry["v"], pos, window)
        x = x + out.reshape(b, 1, -1) @ layer.attn.wo
        # a MoE routes the step as a chunk of one token a row
        x, _ = ffn_sublayer(layer, cfg, x)

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
def prefill(model: Model, tokens=None, *, embeds=None, smax: int | None = None,
            q_chunk: int = 1024):
    """Forward pass over the prompt; returns (float32 last-token logits
    (B, 1, V), cache at ``pos`` = prompt length)."""
    cfg = model.cfg
    model = cast_params(model, cfg.activation_dtype)
    x = embed_inputs(model, tokens, embeds)
    s = x.shape[1]
    smax = smax or s
    if smax < s:
        raise ValueError(f"smax {smax} is shorter than the prompt ({s})")
    positions = torch.arange(s, device=x.device)[None, :]

    layers: list[dict[str, Any]] = []
    for layer in model.layers:
        x, k, v, _ = attn_sublayer(layer, cfg, x, positions, q_chunk)
        layers.append({"k": _capture(cfg, layer.kind, k, smax),
                       "v": _capture(cfg, layer.kind, v, smax)})

    logits = logits_of(model, model.final_norm(x[:, -1:, :]))
    return logits, {"layers": layers, "pos": s}
