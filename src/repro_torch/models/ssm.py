"""Mamba2 (state-space dual) block, the SSM layer of zamba2-7b — the port
of ``repro/models/ssm.py``.

Chunked SSD (Dao & Gu 2024, minimal form): within a chunk of L tokens
the decay-masked quadratic (L × L) form runs dense; across chunks only
the (B, H, P, N) float32 state is carried.  The reference scans the
chunks with ``lax.scan``; here ``partitioning.scan`` (a Python loop,
which the dry run's op counter folds) does the same arithmetic over the
same chunks.  Single B/C group, no norm on dt, a conv kernel of
``CONV_K`` (the reference's simplifications).

Mixed dtypes: ``jnp.einsum`` promotes bfloat16 operands against float32
ones, where ``torch.einsum`` refuses them, so every bfloat16 operand
that meets a float32 one (``x``, B, C against the state, dt and the
decays) is cast to float32 first; products of two bfloat16 operands
(``C·Bᵀ``, ``D·x``) stay in bfloat16, as in the reference.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import RMSNorm, normal_init_, param
from repro_torch.models.partitioning import constrain, hold, local_shards, scan

CONV_K = 4


def ssm_dims(d_model: int, head_dim: int) -> tuple[int, int]:
    """(inner width, heads) of a Mamba2 block on a ``d_model`` stream."""
    d_in = 2 * d_model
    return d_in, d_in // head_dim


def a_log_init(n_heads: int) -> torch.Tensor:
    """``log(linspace(1, 16, H))`` computed in float64 on the host and
    rounded once to float32 (the same on every device; the reference's
    float32 arithmetic lands within a few ulp of it)."""
    return torch.linspace(1.0, 16.0, n_heads, dtype=torch.float64).log().float()


class Mamba2(nn.Module):
    """The reference's leaves under its names: ``in_proj`` (d, 2·d_in +
    2N + H), ``conv_w`` (K, conv_dim), ``conv_b``, ``A_log``, ``D``,
    ``dt_bias`` (H,; ``f32_dtype``, float32 in the masters),
    ``norm.scale`` (d_in,) and ``out_proj`` (d_in, d)."""

    def __init__(self, d: int, n_state: int, head_dim: int, device=None,
                 dtype=torch.float32, f32_dtype=torch.float32):
        super().__init__()
        d_in, h = ssm_dims(d, head_dim)
        conv_dim = d_in + 2 * n_state
        self.n_state, self.head_dim = n_state, head_dim
        self.in_proj = param((d, 2 * d_in + 2 * n_state + h), device, dtype)
        self.conv_w = param((CONV_K, conv_dim), device, dtype)
        self.conv_b = param((conv_dim,), device, dtype)
        self.A_log = param((h,), device, f32_dtype)
        self.D = param((h,), device, f32_dtype)
        self.dt_bias = param((h,), device, f32_dtype)
        self.norm = RMSNorm(d_in, device=device, dtype=dtype)
        self.out_proj = param((d_in, d), device, dtype)

    def init_(self, generator, dtype=None) -> None:
        normal_init_(self.in_proj, generator, dtype=dtype)
        normal_init_(self.conv_w, generator, 0.5, dtype)
        normal_init_(self.out_proj, generator, dtype=dtype)
        with torch.no_grad():
            self.conv_b.zero_()
            self.A_log.copy_(a_log_init(self.A_log.shape[0]))
            self.D.fill_(1.0)
            self.dt_bias.zero_()
        self.norm.init_()


def _split_proj(p: Mamba2, x: torch.Tensor):
    d_in, h = ssm_dims(x.shape[-1], p.head_dim)
    # the split's gradient comes back whole: ``hold`` splits it again as
    # the product's output is, so in_proj's gradient is made in its shard
    z, xbc, dt = torch.split(hold(x @ p.in_proj),
                             [d_in, d_in + 2 * p.n_state, h], dim=-1)
    return z, xbc, dt, d_in, h


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                prev: torch.Tensor | None = None):
    """Depthwise causal conv of kernel ``CONV_K`` -> (silu(conv + bias),
    the last K-1 inputs).  ``prev`` (B, K-1, C) is the decode history;
    ``None`` is zero history (prefill from scratch)."""
    b, s, c = xbc.shape
    if prev is None:
        prev = xbc.new_zeros((b, CONV_K - 1, c))
    ext = torch.cat([prev, xbc], dim=1)
    out = ext[:, :s] * w[0]
    for i in range(1, CONV_K):
        out = out + ext[:, i:i + s] * w[i]
    return F.silu(out + bias), ext[:, -(CONV_K - 1):]


_XS = ("batch", None, "model", None)      # (B, S, H, P)
_BC = ("batch", None, None)                # (B, S, N): one group


def _ssd(xs, dt, bmat, cmat, a, d_skip, *, chunk: int):
    """The chunked SSD scan: xs (B, S, H, P), dt (B, S, H) float32,
    bmat/cmat (B, S, N), a and the skip ``d_skip`` (H,) -> (y (B, S, H,
    P) float32, final state (B, H, P, N) float32)."""
    b, s, h, hp = xs.shape
    n = bmat.shape[-1]
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xs.device).tril()[None, :, :, None]

    def step(i, state):
        if state is None:
            state = torch.zeros((b, h, hp, n), dtype=torch.float32,
                                device=xs.device)
        c0 = i * chunk
        xc, dtc = xs[:, c0:c0 + chunk], dt[:, c0:c0 + chunk]
        bc, cc = bmat[:, c0:c0 + chunk], cmat[:, c0:c0 + chunk]
        xf, bf, cf = xc.float(), bc.float(), cc.float()
        cum = torch.cumsum(dtc * a, dim=1)                    # (B,L,H)
        total = cum[:, -1:, :]                                # (B,1,H)
        # inter-chunk: the carried state's contribution
        y_inter = (torch.einsum("bln,bhpn->blhp", cf, state)
                   * torch.exp(cum)[..., None])
        # intra-chunk: the decay-masked quadratic form, masked before exp
        seg = cum[:, :, None, :] - cum[:, None, :, :]         # (B,L,L,H)
        decay = torch.exp(torch.where(causal, seg, -1e30))
        scores = torch.einsum("bln,bmn->blm", cc, bc)         # (B,L,L)
        w = scores[..., None] * decay                         # (B,L,L,H)
        y_intra = torch.einsum("blmh,bmhp->blhp", w * dtc[:, None], xf)
        rev = torch.exp(total - cum)                          # (B,L,H)
        state = state * torch.exp(total)[:, 0, :, None, None] + torch.einsum(
            "blhp,bln->bhpn", xf * (dtc * rev)[..., None], bf)
        return state, y_intra + y_inter + d_skip[None, None, :, None] * xc

    state, ys = scan(step, s // chunk)
    return torch.cat(ys, dim=1), state


def mamba2_apply(p: Mamba2, x: torch.Tensor, *, chunk: int = 128):
    """x: (B, S, D), S a multiple of ``min(chunk, S)`` -> (y (B, S, D),
    final state (B, H, P, N) float32, conv tail (B, K-1, conv_dim))."""
    b, s, _ = x.shape
    n, hp = p.n_state, p.head_dim
    z, xbc, dt, d_in, h = _split_proj(p, x)
    xbc, conv_tail = causal_conv(xbc, p.conv_w, p.conv_b)
    xs, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)
    xs = constrain(xs.reshape(b, s, h, hp), ("batch", None, "model", None))
    dt = constrain(F.softplus(dt.float() + p.dt_bias),        # (B,S,H)
                   ("batch", None, "model"))
    bmat = constrain(bmat, ("batch", None, None))
    cmat = constrain(cmat, ("batch", None, None))
    a = -torch.exp(p.A_log)                                   # (H,)
    chunk = min(chunk, s)
    assert s % chunk == 0
    # the chunk scan per (row, head): each rank's shard under a policy
    y, state = local_shards(
        functools.partial(_ssd, chunk=chunk),
        (_XS, _XS[:3], _BC, _BC, ("model",), ("model",)),
        (_XS, ("batch", "model", None, None)),
        xs, dt, bmat, cmat, a, p.D)
    y = y.reshape(b, s, d_in).to(x.dtype)
    y = p.norm(y * F.silu(z))
    return y @ p.out_proj, state, conv_tail


def mamba2_decode(p: Mamba2, x: torch.Tensor, state: torch.Tensor,
                  conv_prev: torch.Tensor):
    """One token: x (B, 1, D), state (B, H, P, N) float32, conv_prev
    (B, K-1, conv_dim) -> (y, new state, new conv history)."""
    b = x.shape[0]
    n = p.n_state
    z, xbc, dt, d_in, h = _split_proj(p, x)
    xbc, conv_prev = causal_conv(xbc, p.conv_w, p.conv_b, conv_prev)
    xs, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)
    xs = xs.reshape(b, h, p.head_dim)
    bv, cv = bmat[:, 0].float(), cmat[:, 0].float()          # (B,N)
    dt = F.softplus(dt[:, 0].float() + p.dt_bias)             # (B,H)
    da = torch.exp(dt * -torch.exp(p.A_log))
    state = state * da[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xs.float() * dt[..., None], bv)
    y = (torch.einsum("bn,bhpn->bhp", cv, state)
         + p.D[None, :, None] * xs)
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = p.norm(y * F.silu(z))
    return y @ p.out_proj, state, conv_prev
