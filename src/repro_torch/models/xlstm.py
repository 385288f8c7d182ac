"""xLSTM blocks (Beck et al. 2024): mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, strictly recurrent with head-blocked
recurrent weights) — the port of ``repro/models/xlstm.py``.

mLSTM runs chunkwise like the Mamba2 SSD path: the decay-masked
quadratic form within a chunk, a carried (C, n, m) state across chunks
(``partitioning.scan``, a Python loop over the reference's ``lax.scan``
steps, which the dry run's op counter folds).  sLSTM is such a loop
over time, one cell a token.  The reference's simplifications
stay: the forget gate through ``logsigmoid`` in both cells, per-chunk
stabilisation for mLSTM (the exact stabilised recurrence in decode),
projection factor 2 (mLSTM) and 1 (sLSTM).

As in ``ssm``, a bfloat16 operand that meets a float32 one in an einsum
is cast to float32 first (``jnp.einsum`` promotes, ``torch.einsum``
refuses), and a product of two bfloat16 operands stays bfloat16.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import RMSNorm, normal_init_, param
from repro_torch.models.partitioning import (
    constrain,
    hold,
    local_shards,
    merge_heads,
    pointwise,
    scan,
)

#: the stabiliser ``m`` of an empty memory
M_EMPTY = -1e30


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """``qkv`` (d, 3·2d), ``gates`` (d, 2H), ``ogate`` (d, 2d),
    ``norm.scale`` (2d,), ``out`` (2d, d) and ``fbias`` (H,;
    ``f32_dtype``, float32 in the masters)."""

    def __init__(self, d: int, n_heads: int, device=None,
                 dtype=torch.float32, f32_dtype=torch.float32):
        super().__init__()
        d_in = 2 * d
        self.n_heads = n_heads
        self.qkv = param((d, 3 * d_in), device, dtype)
        self.gates = param((d, 2 * n_heads), device, dtype)
        self.ogate = param((d, d_in), device, dtype)
        self.norm = RMSNorm(d_in, device=device, dtype=dtype)
        self.out = param((d_in, d), device, dtype)
        self.fbias = param((n_heads,), device, f32_dtype)

    def init_(self, generator, dtype=None) -> None:
        normal_init_(self.qkv, generator, dtype=dtype)
        normal_init_(self.gates, generator, 0.01, dtype)
        normal_init_(self.ogate, generator, dtype=dtype)
        normal_init_(self.out, generator, dtype=dtype)
        with torch.no_grad():
            self.fbias.fill_(3.0)          # open forget gates
        self.norm.init_()


def _mlstm_proj(p: MLSTM, x: torch.Tensor):
    b, s, d = x.shape
    hn = p.n_heads
    hp = 2 * d // hn
    # the chunks' gradient comes back whole: ``hold`` splits it again as
    # the product's output is (``ssm._split_proj``)
    q, k, v = torch.chunk(hold(x @ p.qkv), 3, dim=-1)
    q = q.reshape(b, s, hn, hp)
    k = k.reshape(b, s, hn, hp) / math.sqrt(hp)
    v = v.reshape(b, s, hn, hp)
    li, lf = torch.chunk(hold(x @ p.gates).float(), 2, dim=-1)  # (B,S,H)
    lf = pointwise(F.logsigmoid, lf + p.fbias)
    o = torch.sigmoid(x @ p.ogate)
    return q, k, v, li, lf, o


def mlstm_init_state(batch: int, n_heads: int, head_dim: int,
                     device=None) -> tuple:
    """The empty (C, n, m) memory, float32."""
    return (torch.zeros((batch, n_heads, head_dim, head_dim),
                        dtype=torch.float32, device=device),
            torch.zeros((batch, n_heads, head_dim), dtype=torch.float32,
                        device=device),
            torch.full((batch, n_heads), M_EMPTY, dtype=torch.float32,
                       device=device))


_QKV = ("batch", None, "model", None)     # (B, S, H, P)


def _mlstm_scan(q, k, v, li, lf, *, chunk: int):
    """The chunkwise mLSTM: q, k, v (B, S, H, P), li, lf (B, S, H)
    float32 -> (h (B, S, H, P) float32, the final (C, n, m))."""
    b, s, hn, hp = q.shape
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).tril()[None, :, :, None]

    def step(i, carry):
        c_st, n_st, m_st = carry or mlstm_init_state(b, hn, hp, q.device)
        c0 = i * chunk
        qt, kt, vt = (t[:, c0:c0 + chunk] for t in (q, k, v))   # (B,L,H,P)
        lit, lft = li[:, c0:c0 + chunk], lf[:, c0:c0 + chunk]    # (B,L,H)
        qf, kf, vf = qt.float(), kt.float(), vt.float()
        cum = torch.cumsum(lft, dim=1)
        total = cum[:, -1, :]                                    # (B,H)
        # log strength of token j at the chunk origin: a_j = li_j - cum_j
        a = lit - cum
        amax = torch.cummax(a, dim=1).values                     # max_{j<=i}
        m_new = cum + torch.maximum(m_st[:, None, :], amax)      # (B,L,H)
        # inter: the decayed carry-in (the state carries scale e^{-m_st})
        inter_w = torch.exp(m_st[:, None, :] + cum - m_new)
        num_inter = (torch.einsum("blhp,bhqp->blhq", qf, c_st)
                     * inter_w[..., None])
        den_inter = torch.einsum("blhp,bhp->blh", qf, n_st) * inter_w
        # intra: w_ij = exp(cum_i - cum_j + li_j - m_i), j <= i; masked
        # before the exp
        logw = (cum - m_new)[:, :, None, :] + a[:, None, :, :]
        w = torch.exp(torch.where(causal, logw, -1e30))
        sw = torch.einsum("blhp,bmhp->blmh", qt, kt) * w          # (B,L,L,H)
        num = num_inter + torch.einsum("blmh,bmhp->blhp", sw, vf)
        den = den_inter + sw.sum(dim=2)
        h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
        # the state update, stabilised at the chunk end's max
        m_out = total + torch.maximum(m_st, amax[:, -1, :])       # (B,H)
        carry_w = torch.exp(m_st + total - m_out)
        in_w = torch.exp(total[:, None, :] + a - m_out[:, None, :])
        c_st = c_st * carry_w[..., None, None] + torch.einsum(
            "bmhp,bmhq->bhpq", vf * in_w[..., None], kf)
        n_st = n_st * carry_w[..., None] + torch.einsum(
            "bmhp,bmh->bhp", kf, in_w)
        return (c_st, n_st, m_out), h

    state, hs = scan(step, s // chunk)
    return (torch.cat(hs, dim=1), *state)


def mlstm_apply(p: MLSTM, x: torch.Tensor, *, chunk: int = 128):
    """x: (B, S, D), S a multiple of ``min(chunk, S)`` -> (y (B, S, D),
    the final (C, n, m)).  The chunk scan runs per (row, head): each
    rank's shard under a policy."""
    b, s, d = x.shape
    q, k, v, li, lf, o = _mlstm_proj(p, x)
    chunk = min(chunk, s)
    assert s % chunk == 0
    h, c_st, n_st, m_st = local_shards(
        functools.partial(_mlstm_scan, chunk=chunk),
        (_QKV,) * 3 + (_QKV[:3],) * 2,
        (_QKV, ("batch", "model", None, None), ("batch", "model", None),
         ("batch", "model")),
        q, k, v, li, lf)
    y = p.norm(merge_heads(h).to(x.dtype) * o)
    return y @ p.out, (c_st, n_st, m_st)


def mlstm_decode(p: MLSTM, x: torch.Tensor, state: tuple):
    """One token: x (B, 1, D), state (C, n, m) -> (y, new state)."""
    b, _, d = x.shape
    q, k, v, li, lf, o = _mlstm_proj(p, x)
    qt, kt, vt = q[:, 0], k[:, 0], v[:, 0]                       # (B,H,P)
    lit, lft = li[:, 0], lf[:, 0]                                # (B,H)
    rows = ("batch", "model", None)
    h, *state = local_shards(
        _mlstm_step, (rows,) * 3 + (rows[:2],) * 2 + (rows + (None,), rows,
                                                      rows[:2]),
        (rows, rows + (None,), rows, rows[:2]), qt, kt, vt, lit, lft, *state)
    y = p.norm(h.reshape(b, 1, 2 * d).to(x.dtype) * o)
    return y @ p.out, tuple(state)


def _mlstm_step(qt, kt, vt, lit, lft, c_st, n_st, m_st):
    """One token's memory update and read: q, k, v (B, H, P), li, lf
    (B, H) -> (h (B, H, P) float32, the new (C, n, m))."""
    m_new = torch.maximum(lft + m_st, lit)
    fw = torch.exp(lft + m_st - m_new)
    iw = torch.exp(lit - m_new)
    c_new = (c_st * fw[..., None, None]
             + torch.einsum("bhp,bhq->bhpq", vt, kt) * iw[..., None, None])
    n_new = n_st * fw[..., None] + kt * iw[..., None]
    qf = qt.float()
    num = torch.einsum("bhp,bhqp->bhq", qf, c_new)
    den = torch.einsum("bhp,bhp->bh", qf, n_new)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h, c_new, n_new, m_new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


class SLSTM(nn.Module):
    """``wx`` (d, 4d), ``r`` (H, P, 4P), ``fbias`` (d,; ``f32_dtype``,
    float32 in the masters), ``norm.scale`` (d,) and ``out`` (d, d)."""

    def __init__(self, d: int, n_heads: int, device=None,
                 dtype=torch.float32, f32_dtype=torch.float32):
        super().__init__()
        hp = d // n_heads
        self.n_heads = n_heads
        self.wx = param((d, 4 * d), device, dtype)
        self.r = param((n_heads, hp, 4 * hp), device, dtype)
        self.fbias = param((d,), device, f32_dtype)
        self.norm = RMSNorm(d, device=device, dtype=dtype)
        self.out = param((d, d), device, dtype)

    def init_(self, generator, dtype=None) -> None:
        # r scales over its shape[0] (the heads), as the reference's
        # normal_init does
        for w in (self.wx, self.r, self.out):
            normal_init_(w, generator, dtype=dtype)
        with torch.no_grad():
            self.fbias.fill_(3.0)
        self.norm.init_()


def slstm_init_state(batch: int, d: int, device=None) -> tuple:
    """The empty (c, n, h, m) memory, float32."""
    zeros = [torch.zeros((batch, d), dtype=torch.float32, device=device)
             for _ in range(3)]
    return (*zeros, torch.full((batch, d), M_EMPTY, dtype=torch.float32,
                               device=device))


def _slstm_cell(r: torch.Tensor, fbias: torch.Tensor, xg: torch.Tensor,
                state: tuple):
    """xg: (B, 4d) float32 pre-activations from x; r: (H, P, 4P) float32.

    The recurrent term is computed per head, then flattened to (B, 4d)
    and split into the four gates, so the gates interleave heads (the
    reference's layout, which ``wx`` and ``r`` assume)."""
    c, n, h, m = state
    hn, hp = r.shape[:2]
    rg = torch.einsum("bhp,hpq->bhq", h.reshape(-1, hn, hp), r)
    zi, zf, zz, zo = torch.chunk(xg + rg.reshape(xg.shape), 4, dim=-1)
    lf = F.logsigmoid(zf + fbias)
    m_new = torch.maximum(lf + m, zi)
    i = torch.exp(zi - m_new)
    f = torch.exp(lf + m - m_new)
    c_new = f * c + i * torch.tanh(zz)
    n_new = f * n + i
    h_new = torch.sigmoid(zo) * c_new / torch.clamp(n_new, min=1.0)
    return c_new, n_new, h_new, m_new


def slstm_apply(p: SLSTM, x: torch.Tensor):
    """x: (B, S, D) -> (y (B, S, D), the final (c, n, h, m)): one cell a
    token, in order."""
    b, s, d = x.shape
    xg = (x @ p.wx).float()                                 # (B,S,4d)
    # the token loop per row: each rank's rows under a policy (the
    # gates mix heads, so the heads stay whole)
    hs, *state = local_shards(
        _slstm_scan, (_ROWS + (None,), (None,) * 3, (None,)),
        (_ROWS + (None,),) + (_ROWS,) * 4, xg, p.r.float(), p.fbias)
    # the rows' outputs come whole along d: split them over "model" for
    # the row-parallel ``out``, so its gradient is made in its shard
    y = constrain(p.norm(hs.to(x.dtype)), ("batch", None, "model"))
    return y @ p.out, tuple(state)


_ROWS = ("batch", None)            # (B, d): a row's state, heads whole


def _slstm_scan(xg, r, fbias):
    """xg (B, S, 4d) float32 -> (h (B, S, d), the final c, n, h, m)."""
    b, s, d4 = xg.shape

    def step(t, state):
        state = _slstm_cell(r, fbias, xg[:, t],
                            state or slstm_init_state(b, d4 // 4, xg.device))
        return state, state[2]

    state, hs = scan(step, s)
    return (torch.stack(hs, dim=1), *state)


def slstm_decode(p: SLSTM, x: torch.Tensor, state: tuple):
    """One token: x (B, 1, D), state (c, n, h, m) -> (y, new state)."""
    xg = (x[:, 0] @ p.wx).float()
    state = local_shards(
        lambda r, fb, xg, *st: _slstm_cell(r, fb, xg, st),
        ((None,) * 3, (None,), _ROWS) + (_ROWS,) * 4, (_ROWS,) * 4,
        p.r.float(), p.fbias, xg, *state)
    y = p.norm(state[2][:, None, :].to(x.dtype))
    return y @ p.out, tuple(state)
