"""Shared building blocks: norms, MLPs, rotary embeddings, embedding
tables — the port of ``repro/models/layers.py``.

Each block is a plain function on tensors, with the reference's dtype
at every rounding point, and a small ``nn.Module`` that owns its
parameters under the reference's leaf names.  Weights keep the
reference's ``(d_in, d_out)`` layout (``x @ W``), not ``nn.Linear``'s,
so a parameter tree converts leaf for leaf.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.partitioning import constrain, last_mean, vocab_take


def param(shape, device=None, dtype=torch.float32) -> nn.Parameter:
    """An uninitialised parameter (``init_params`` fills it)."""
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype))


#: Φ(±2): the uniform range whose inverse normal CDF is [-2, 2].
_CDF_LO, _CDF_HI = ((1.0 + math.erf(z / math.sqrt(2.0))) / 2.0
                    for z in (-2.0, 2.0))


def normal_init_(p: torch.Tensor, generator: torch.Generator,
                 scale: float | None = None,
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """Truncated normal on [-2, 2] × ``scale`` (1/√fan_in by default),
    fan_in = ``shape[0]``: the reference's ``normal_init`` distribution,
    drawn from ``generator`` where ``p`` lives.  By the inverse CDF: one
    uniform draw a value and no rejection loop (``nn.init.trunc_normal_``
    redraws the whole tensor until no value falls outside, which took
    seconds per 1e8 values on a CPU).

    The values are drawn in ``dtype`` (``p``'s own by default) and cast
    into ``p``: a served copy draws each parameter in its master dtype
    into a temporary of that one parameter, so it equals the masters
    drawn from the same generator and cast."""
    fan_in = p.shape[0] if p.ndim > 1 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    with torch.no_grad():
        t = p if dtype in (None, p.dtype) else torch.empty_like(p, dtype=dtype)
        t.uniform_(2 * _CDF_LO - 1, 2 * _CDF_HI - 1, generator=generator)
        t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(std)
        return p if t is p else p.copy_(t)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style ``x · rsqrt(mean(x²) + eps) · (1 + scale)`` in float32,
    cast back to ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = last_mean(x.square())
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = param((d,), device, dtype)

    def init_(self) -> None:
        with torch.no_grad():
            self.scale.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


# ---------------------------------------------------------------------------
# MLP (dense FFN): silu (SwiGLU), geglu, gelu
# ---------------------------------------------------------------------------


def mlp(x: torch.Tensor, activation: str, up: torch.Tensor,
        down: torch.Tensor, gate: torch.Tensor | None = None) -> torch.Tensor:
    if activation == "silu":
        h = F.silu(x @ gate) * (x @ up)
    elif activation == "geglu":
        h = F.gelu(x @ gate, approximate="tanh") * (x @ up)
    else:
        h = F.gelu(x @ up, approximate="tanh")
    if h.ndim == 3:
        h = constrain(h, ("batch", None, "model"))
    return h @ down


class MLP(nn.Module):
    def __init__(self, d: int, f: int, activation: str, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.activation = activation
        self.down = param((f, d), device, dtype)
        self.up = param((d, f), device, dtype)
        self.gate = (param((d, f), device, dtype)
                     if activation in ("silu", "geglu") else None)

    def init_(self, generator, dtype=None) -> None:
        for p in (self.gate, self.up, self.down):
            if p is not None:
                normal_init_(p, generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(x, self.activation, self.up, self.down, self.gate)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) integer.  float32 cos/sin
    mix with ``x`` (promoting it), and the result is cast back."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq           # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def embed(table: torch.Tensor, tokens: torch.Tensor, d: int) -> torch.Tensor:
    """Row gather scaled by √d, the factor rounded to the table's dtype
    first (gemma-style scaling; a host scalar, so no copy to the
    device)."""
    out = vocab_take(table, tokens, 0, lambda t, i: t[i])
    return out * torch.tensor(math.sqrt(d), dtype=out.dtype).item()


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x @ table.T


def softcap(logits: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return logits
    return cap * torch.tanh(logits / cap)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, device=None, dtype=torch.float32):
        super().__init__()
        self.d = d
        self.table = param((vocab, d), device, dtype)

    def init_(self, generator, dtype=None) -> None:
        # std 1/sqrt(d): the sqrt(d) forward scaling then yields a
        # unit-variance residual stream AND unit-variance tied logits.
        normal_init_(self.table, generator, self.d ** -0.5, dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed(self.table, tokens, self.d)
