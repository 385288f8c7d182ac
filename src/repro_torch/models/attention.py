"""Attention: GQA/MQA/MHA with RoPE, flash-style chunked softmax (memory
O(S·chunk), never materialising the (S, S) logits), sliding-window band
attention, cross-attention, and single-token decode against a KV cache
— the port of ``repro/models/attention.py``.

The reference's flash path is plain ``lax``: one scan over a static
list of (q-block, kv-block) tiles with an online softmax.  This is the
same algorithm in plain PyTorch: a Python loop over the same tile list,
with the same masks, ``NEG_INF`` and ``1e-37`` guards, and the same
dtype at each step.  The backward is the reference's custom VJP
(``_flash_call_bwd``) as a ``torch.autograd.Function``: the forward
keeps each row's log-sum-exp, and the backward recomputes every tile
from it.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import partitioning as PT
from repro_torch.models.layers import RMSNorm, normal_init_, param, rope

NEG_INF = -1e30


class AttnDims(NamedTuple):
    n_heads: int
    n_kv_heads: int
    head_dim: int


class Attention(nn.Module):
    """The projections of one attention block: ``wq``/``wk``/``wv``/``wo``
    in ``(d_in, d_out)`` layout, optional QKV biases and QK norms."""

    def __init__(self, d: int, dims: AttnDims, qkv_bias: bool = False,
                 qk_norm: bool = False, device=None, dtype=torch.float32):
        super().__init__()
        h, kv, hd = dims
        self.dims = dims
        self.wq = param((d, h * hd), device, dtype)
        self.wk = param((d, kv * hd), device, dtype)
        self.wv = param((d, kv * hd), device, dtype)
        self.wo = param((h * hd, d), device, dtype)
        self.bq = self.bk = self.bv = None
        if qkv_bias:
            self.bq = param((h * hd,), device, dtype)
            self.bk = param((kv * hd,), device, dtype)
            self.bv = param((kv * hd,), device, dtype)
        self.q_norm = self.k_norm = None
        if qk_norm:
            self.q_norm = RMSNorm(hd, device=device, dtype=dtype)
            self.k_norm = RMSNorm(hd, device=device, dtype=dtype)

    def init_(self, generator, dtype=None) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            normal_init_(w, generator, dtype=dtype)
        with torch.no_grad():
            for b in (self.bq, self.bk, self.bv):
                if b is not None:
                    b.zero_()
        for norm in (self.q_norm, self.k_norm):
            if norm is not None:
                norm.init_()


def qkv(p: Attention, x: torch.Tensor, positions: torch.Tensor,
        rope_theta: float):
    """x: (B, S, D) -> q (B, S, H, hd), k, v (B, S, KV, hd), QK-normed
    (with the norm's default eps, as the reference) and rotated."""
    h, kv_h, hd = p.dims
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if p.bq is not None:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q, k, v = (PT.split_heads(q, h, hd), PT.split_heads(k, kv_h, hd),
               PT.split_heads(v, kv_h, hd))
    if p.q_norm is not None:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if rope_theta:
        q = rope(q, positions, rope_theta)
        k = rope(k, positions, rope_theta)
    return q, k, v


# ---------------------------------------------------------------------------
# flash attention (chunked online softmax)
# ---------------------------------------------------------------------------


def _tile_mask(qpos, kpos, causal, window, kv_len):
    mask = (kpos < kv_len)[None, :]
    if causal:
        mask = mask & (qpos[:, None] >= kpos[None, :])
    if window is not None:
        mask = mask & (qpos[:, None] - kpos[None, :] < window)
    return mask


def _block_attend(q, k, v, qpos, kpos, scale, causal, window, kv_len):
    """One (q-block, kv-block) tile.  q: (B, qc, KV, G, hd); k, v:
    (B, kc, KV, hd).  Returns the tile's row max, sum of exponentials
    and exp-weighted values for the online softmax."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    mask = _tile_mask(qpos, kpos, causal, window, kv_len)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1)                                           # (B,KV,G,qc)
    p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, 0.0)
    l = p.sum(-1)                                            # (B,KV,G,qc)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype), v)
    return m, l, pv


def flash_tiles(nq: int, nk: int, causal: bool,
                window: int | None) -> list[tuple[int, int, int]]:
    """The static tile list: exactly the (q-block, kv-block, valid)
    triples that carry an unmasked entry — the lower triangle for causal
    attention, a two-block band for a sliding window (block 0's first
    tile is a placeholder, ``valid`` 0), the full grid for cross
    attention."""
    pairs = []
    for qi in range(nq):
        if not causal:
            pairs += [(qi, ki, 1) for ki in range(nk)]
        elif window is not None:
            pairs.append((qi, qi - 1, 1) if qi > 0 else (qi, 0, 0))
            pairs.append((qi, qi, 1))
        else:
            pairs += [(qi, ki, 1) for ki in range(qi + 1)]
    return pairs


def tiles_at(q0: int, nq: int, qc: int, nk: int, kc: int, causal: bool,
             window: int | None) -> list[tuple[int, int, int]]:
    """``flash_tiles`` for query blocks of ``qc`` rows whose first row
    sits at position ``q0`` (one rank's block of a sequence split over
    "model"), against kv blocks of ``kc`` from position 0: every
    (q-block, kv-block, 1) whose mask can hold an unmasked entry."""
    pairs = []
    for qi in range(nq):
        first = q0 + qi * qc
        last = first + qc - 1
        pairs += [(qi, ki, 1) for ki in range(nk)
                  if (not causal or ki * kc <= last)
                  and (window is None or (ki + 1) * kc - 1 > first - window)]
    return pairs


class _FlashCfg(NamedTuple):
    causal: bool
    window: int | None
    q_chunk: int
    kv_chunk: int
    sk0: int            # unpadded kv length (padding mask)
    q0: int = 0         # the first query's position

    def tiles(self, nq: int, nk: int) -> list[tuple[int, int, int]]:
        if self.q0 == 0 and self.q_chunk == self.kv_chunk:
            return flash_tiles(nq, nk, self.causal, self.window)
        return tiles_at(self.q0, nq, self.q_chunk, nk, self.kv_chunk,
                        self.causal, self.window)


def _flash_fwd(cfgt: _FlashCfg, q, k, v, want_lse: bool):
    """The tile loop over padded q (B, Sq, H, hd), k, v (B, Sk, KV, hd)
    -> (out in q's dtype, each row's log-sum-exp (nq, B, KV, G, qc) in
    float32, or ``None`` without ``want_lse``)."""
    b, sq, h, hd = q.shape
    kv_h = k.shape[2]
    g = h // kv_h
    qc, kc = cfgt.q_chunk, cfgt.kv_chunk
    nq, nk = sq // qc, k.shape[1] // kc
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qb = q.reshape(b, nq, qc, kv_h, g, hd)
    m = torch.full((nq, b, kv_h, g, qc), NEG_INF, device=dev)
    l = torch.zeros((nq, b, kv_h, g, qc), device=dev)
    acc = torch.zeros((nq, b, kv_h, g, qc, hd), device=dev)
    qrange = torch.arange(qc, device=dev)
    krange = torch.arange(kc, device=dev)
    for qi, ki, valid in cfgt.tiles(nq, nk):
        kt = k[:, ki * kc:(ki + 1) * kc]
        vt = v[:, ki * kc:(ki + 1) * kc]
        bm, bl, bpv = _block_attend(qb[:, qi], kt, vt,
                                    cfgt.q0 + qi * qc + qrange,
                                    ki * kc + krange, scale, cfgt.causal,
                                    cfgt.window, cfgt.sk0)
        if not valid:
            bm = torch.full_like(bm, NEG_INF)
        m_new = torch.maximum(m[qi], bm)
        alpha = torch.exp(m[qi] - m_new)
        beta = torch.exp(bm - m_new)
        l[qi] = l[qi] * alpha + bl * beta
        acc[qi] = acc[qi] * alpha[..., None] + bpv.float() * beta[..., None]
        m[qi] = m_new
    out = acc / torch.clamp(l, min=1e-37)[..., None]
    # (nq, B, KV, G, qc, hd) -> (B, Sq, H, hd)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(b, sq, h, hd).to(q.dtype)
    # a fully masked row (l == 0) keeps a finite log-sum-exp
    lse = m + torch.log(torch.clamp(l, min=1e-37)) if want_lse else None
    return out, lse


def _flash_bwd(cfgt: _FlashCfg, q, k, v, out, lse, dout):
    """The reference's ``_flash_call_bwd``, tile for tile: ``p`` from
    each tile's recomputed scores and the saved ``lse`` under the tile
    mask, ``dv += pᵀ·dout``, ``ds = p·(dp − delta)·scale``; dq, dk, dv
    accumulated in float32 and cast to the inputs' dtypes.  The band's
    placeholder tile (``valid`` 0) has ``p`` zero and is skipped."""
    b, sq, h, hd = q.shape
    kv_h = k.shape[2]
    g = h // kv_h
    qc, kc = cfgt.q_chunk, cfgt.kv_chunk
    nq, nk = sq // qc, k.shape[1] // kc
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qb = q.reshape(b, nq, qc, kv_h, g, hd)
    dob = dout.float().reshape(b, nq, qc, kv_h, g, hd)
    ob = out.float().reshape(b, nq, qc, kv_h, g, hd)
    delta = torch.einsum("bnqkgd,bnqkgd->bnkgq", dob, ob)
    dq = torch.zeros((b, nq, qc, kv_h, g, hd), device=dev)
    dk = torch.zeros(k.shape, device=dev)
    dv = torch.zeros(v.shape, device=dev)
    qrange = torch.arange(qc, device=dev)
    krange = torch.arange(kc, device=dev)
    for qi, ki, valid in cfgt.tiles(nq, nk):
        if not valid:
            continue
        qt, dot, dlt = qb[:, qi], dob[:, qi], delta[:, qi]
        kt = k[:, ki * kc:(ki + 1) * kc]
        vt = v[:, ki * kc:(ki + 1) * kc]
        s = torch.einsum("bqkgd,bskd->bkgqs", qt, kt).float() * scale
        mask = _tile_mask(cfgt.q0 + qi * qc + qrange, ki * kc + krange,
                          cfgt.causal, cfgt.window, cfgt.sk0)
        p = torch.where(mask, torch.exp(s - lse[qi][..., None]), 0.0)
        # dv += pᵀ dout; dp = dout vᵀ; ds = p (dp − delta)
        dv[:, ki * kc:(ki + 1) * kc] += torch.einsum(
            "bkgqs,bqkgd->bskd", p, dot)
        dp = torch.einsum("bqkgd,bskd->bkgqs", dot, vt.float())
        ds = p * (dp - dlt[..., None]) * scale
        dq[:, qi] += torch.einsum("bkgqs,bskd->bqkgd", ds, kt.float())
        dk[:, ki * kc:(ki + 1) * kc] += torch.einsum(
            "bkgqs,bqkgd->bskd", ds, qt.float())
    return (dq.reshape(b, sq, h, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """The tile loop with the reference's custom VJP: the running max,
    sum and accumulator are written in place inside ``forward``, where
    autograd does not see them, and only (q, k, v, out, lse) are
    saved."""

    @staticmethod
    def forward(ctx, q, k, v, cfgt: _FlashCfg):
        out, lse = _flash_fwd(cfgt, q, k, v, want_lse=True)
        ctx.cfgt = cfgt
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_bwd(ctx.cfgt, q, k, v, out, lse, dout), None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    merged: bool = False,
) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd), or with
    ``merged`` (B, Sq, H·hd) (the merged dim placed on "model" under a
    policy, as the reference constrains it before ``wo``).

    Query head ``h`` attends with KV head ``h // (H // KV)``.  A sliding
    window needs ``window <= kv_chunk == q_chunk`` (``ValueError``
    otherwise, where the reference asserts).  Where autograd wants a
    gradient the loop runs inside ``_FlashAttention`` (memory O(S·chunk)
    in both passes); otherwise (serving, under ``no_grad``) it keeps no
    log-sum-exp.  On DTensors under a policy it runs on each rank's
    shard (``partitioning.per_head``, or ``partitioning.attend_merged``
    with ``merged``): the batch and heads placed as the reference
    constrains its carries, the tile loop on plain tensors."""
    qc, kc = min(q_chunk, q.shape[1]), min(kv_chunk, k.shape[1])
    if window is not None and not (window <= kc and qc == kc):
        raise ValueError(
            f"band path needs window <= kv_chunk == q_chunk, got window="
            f"{window}, kv_chunk={kc}, q_chunk={qc}")
    fn = functools.partial(_flash, causal=causal, window=window,
                           q_chunk=q_chunk, kv_chunk=kv_chunk)
    if merged:
        return PT.attend_merged(fn, q, k, v)
    return PT.per_head(fn, q, k, v)


def _flash(q, k, v, *, causal, window, q_chunk, kv_chunk, q_start=0):
    """``flash_attention`` on plain tensors (or one rank's shards):
    queries at positions ``q_start`` onwards (a block of a sequence
    split over "model"), keys at 0 onwards."""
    sq0, sk0 = q.shape[1], k.shape[1]
    q_chunk = min(q_chunk, sq0)
    kv_chunk = min(kv_chunk, sk0)
    # pad to chunk multiples; padded keys are masked via the kv length,
    # padded query rows are sliced off the output
    sq = math.ceil(sq0 / q_chunk) * q_chunk
    sk = math.ceil(sk0 / kv_chunk) * kv_chunk
    if sq != sq0:
        q = F.pad(q, (0, 0, 0, 0, 0, sq - sq0))
    if sk != sk0:
        k = F.pad(k, (0, 0, 0, 0, 0, sk - sk0))
        v = F.pad(v, (0, 0, 0, 0, 0, sk - sk0))
    cfgt = _FlashCfg(causal, window, q_chunk, kv_chunk, sk0, q_start)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _FlashAttention.apply(q, k, v, cfgt)
    else:
        out, _ = _flash_fwd(cfgt, q, k, v, want_lse=False)
    return out[:, :sq0]


# ---------------------------------------------------------------------------
# decode (single token against a cache)
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,          # (B, 1, H, hd)
    k_cache: torch.Tensor,    # (B, Smax, KV, hd)
    v_cache: torch.Tensor,
    pos: int,                 # index of the current token
    window: int | None = None,
) -> torch.Tensor:
    """On DTensors under a policy it runs as
    ``partitioning.cache_attend`` places it."""
    return PT.cache_attend(functools.partial(
        _decode_attention, pos=pos, window=window), q, k_cache, v_cache)


def _decode_attention(q, k_cache, v_cache, *, pos, window):
    """``decode_attention`` on plain tensors, one rank's shards or a
    sequence-split DTensor cache."""
    b, smax, kv_h, hd = k_cache.shape
    h = q.shape[2]
    g = h // kv_h
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kv_h, g, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache).float() * scale
    idx = torch.arange(smax, device=q.device)
    mask = idx <= pos
    if window is not None:
        mask = mask & (idx > pos - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, 1, h, hd)
