"""Mixture-of-Experts FFN: token-choice top-k routing with capacity,
deepseek-style shared experts, arctic-style dense residual branch — the
port of ``repro/models/moe.py``.

Routing runs over sequence chunks of ``router_chunk`` tokens, as the
reference's scan does, and each chunk gives every expert ``C`` capacity
slots (``_capacity``).  An assignment whose place in its expert's queue
is ``C`` or more is dropped, and its row's other weights are not
renormalised.

Deliberate difference (``ROADMAP.md`` §3): the reference counts a
token's place per batch row but then sums its dispatch over the rows,
so two rows whose tokens take the same (expert, slot) go through the
expert as their sum, and one request's activations change another's
outputs.  Here every batch row has its own ``(E, C)`` slots: a batch
equals its rows run alone, and a ``B = 1`` call equals the reference's.

The dispatch is a scatter of each kept assignment's token into its slot
and the combine a gather of the slots back, weighted; the expert
products are batched matrix products over all experts (the reference's
einsums), so a decode step reads every expert's weights.  Nothing reads
back to the host.

Under an activation policy (``partitioning``) a rank routes,
dispatches and combines its own batch rows for its own experts: routing
is independent row by row, so no activation moves before the expert
products (the router's weights are gathered whole).  The rows stay on
the batch axes; the router product, softmax, top k and queue positions
run on them (``local_shards``).  The dispatch fills the slots of the
rank's ``E / M`` experts along "model" for its rows
(``expert_shards``): the rank's block of the ``(E, B·C, D)`` slots.
The slots are gathered over the batch axes for the expert products at
the weights' placements (experts over "model", the hidden dim over the
batch axes), and the down product's pending sum is reduce-scattered
back onto the rank's rows.  The combine weighs the rank's rows'
assignments to its experts; the sum over "model" of the ranks' shares
is the output.  No rank holds another row's routing or all experts'
slots.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import MLP, normal_init_, param
from repro_torch.models.partitioning import (constrain, expert_shards,
                                             gather, local_shards, row_mean)

#: (B, Cs, ·): the batch rows over the batch axes
ROWS = ("batch", None, None)
#: (E, B·C, D): the experts over "model", each row's slots with its row
SLOTS = ("model", "batch", None)


class MoE(nn.Module):
    """The reference's leaves under its names: ``router`` (d, E),
    ``gate``/``up`` (E, d, f), ``down`` (E, f, d), and the ``shared``
    and ``dense`` MLPs where the configuration has them."""

    def __init__(self, d: int, cfg: MoEConfig, activation: str, device=None,
                 dtype=torch.float32, router_dtype=torch.float32):
        super().__init__()
        e, f = cfg.n_experts, cfg.d_expert
        self.d, self.f = d, f
        self.router = param((d, e), device, router_dtype)
        self.gate = param((e, d, f), device, dtype)
        self.up = param((e, d, f), device, dtype)
        self.down = param((e, f, d), device, dtype)
        self.shared = (MLP(d, cfg.n_shared * f, activation, device, dtype)
                       if cfg.n_shared else None)
        self.dense = (MLP(d, cfg.dense_residual_ff, activation, device, dtype)
                      if cfg.dense_residual_ff else None)

    def init_(self, generator, dtype=None) -> None:
        """The reference's scales: the router at 1/√d drawn in float32
        (its master dtype), the experts at 1/√d (gate, up) and 1/√f
        (down) — not ``normal_init_``'s fan-in, which for a 3-D expert
        tensor would be E."""
        normal_init_(self.router, generator, dtype=torch.float32)
        for p, fan_in in ((self.gate, self.d), (self.up, self.d),
                          (self.down, self.f)):
            normal_init_(p, generator, 1.0 / math.sqrt(fan_in), dtype)
        for mlp in (self.shared, self.dense):
            if mlp is not None:
                mlp.init_(generator, dtype)


def _capacity(tokens_per_expert: float, cf: float) -> int:
    c = math.ceil(tokens_per_expert * cf)
    return max(4, math.ceil(c / 4) * 4)


class Routing(NamedTuple):
    """One chunk's routing, each (B, Cs, K) but the last two."""

    gate_idx: torch.Tensor  # int64: the token's k experts
    gate_w: torch.Tensor    # float32: their weights, normalised over K
    pos: torch.Tensor       # the assignment's place in its expert's
    #                         queue within its row
    valid: torch.Tensor     # pos < C: the assignment is kept
    probs: torch.Tensor     # (B, Cs, E) float32 router probabilities
    chosen: torch.Tensor    # (B, Cs, E) int32: 1 where the token chose e


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig) -> Routing:
    """One chunk's routing, x: (B, Cs, D).  The top k is a stable
    descending sort, so tied probabilities (a zero pad token's are
    uniform) take the lowest experts first, as ``lax.top_k`` does."""
    b, cs, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cs * k / e, cfg.capacity_factor)
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate_w, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
    gate_w, gate_idx = gate_w[..., :k], gate_idx[..., :k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    # a token's k experts are distinct, so its place in expert e's queue
    # is the number of earlier tokens of its row that chose e
    chosen = torch.zeros_like(probs, dtype=torch.int32)      # (B,Cs,E)
    chosen.scatter_(-1, gate_idx, 1)
    pos = (chosen.cumsum(1) - chosen).gather(-1, gate_idx)
    return Routing(gate_idx, gate_w, pos, pos < cap, probs, chosen)


def _experts(moe: MoE, xe: torch.Tensor, activation: str) -> torch.Tensor:
    """xe: (E, N, D) -> (E, N, D) through each expert's FFN."""
    if activation in ("silu", "geglu"):
        g = torch.bmm(xe, moe.gate)
        g = F.silu(g) if activation == "silu" else F.gelu(g,
                                                           approximate="tanh")
        h = g * torch.bmm(xe, moe.up)
    else:
        h = F.gelu(torch.bmm(xe, moe.up), approximate="tanh")
    # expert hidden: F rides the batch axes (the weights' sharding); the
    # down product's pending sum over them goes back to the rows' slots
    h = constrain(h, ("model", None, "batch"))
    return constrain(torch.bmm(h, moe.down), SLOTS)


def _route_rows(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
                cap: int) -> tuple:
    """``route``'s fields and each assignment's row of the ``(E·B·C, D)``
    slots of these B rows, (B, Cs, K): slot (e, b, c) is row
    e·B·C + b·C + c; a dropped assignment's is the spare row E·B·C past
    the end."""
    r = route(x, router, cfg)
    b = x.shape[0]
    rows = torch.arange(b, device=x.device).view(b, 1, 1) * cap
    slot = r.gate_idx * (b * cap) + rows + r.pos
    return (*r, torch.where(r.valid, slot, cfg.n_experts * b * cap))


def _own(slot: torch.Tensor, first: int, count: int, per: int):
    """``_route_rows``' slot rows, of ``per`` rows an expert, as rows of
    the slots of experts ``first`` to ``first + count``; an assignment
    to another expert, or dropped, takes the spare row past the end."""
    slot = slot - first * per
    return torch.where((slot >= 0) & (slot < count * per), slot, count * per)


def _route_chunk(moe: MoE, x: torch.Tensor, cfg: MoEConfig,
                 activation: str):
    """x: (B, Cs, D) -> (B, Cs, D) through the routed experts, aux."""
    _, cs, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cs * k / e, cfg.capacity_factor)
    dtype = x.dtype
    x = constrain(x, ROWS)
    *r, slot = local_shards(lambda x, w: _route_rows(x, w, cfg, cap),
                            (ROWS, (None, None)), (ROWS,) * 7, x, moe.router)
    r = Routing(*r)

    def dispatch(first, count, x, slot):
        b = x.shape[0]
        if count < e:
            slot = _own(slot, first, count, b * cap)
        xe = x.new_zeros((count * b * cap + 1, d))
        xe.index_copy_(0, slot.reshape(-1),
                       x.unsqueeze(2).expand(b, cs, k, d).reshape(-1, d))
        return xe[:-1].view(count, b * cap, d)

    # the weights cast to the activation dtype before the sum over K, as
    # the reference's combine tensor is; a dropped assignment, or one to
    # another rank's expert, weighs 0 (its slot index is kept in range)
    def combine(first, count, ye, gate_w, valid, slot):
        b = gate_w.shape[0]
        n = count * b * cap
        if count < e:
            slot = _own(slot, first, count, b * cap)
            valid = slot < n
        w = torch.where(valid, gate_w, 0.0).to(dtype).reshape(b * cs, 1, k)
        yk = ye.reshape(n, d)[slot.reshape(-1).clamp_max(n - 1)]
        return torch.bmm(w, yk.view(b * cs, k, d)).view(b, cs, d)

    xe = expert_shards(dispatch, e, (ROWS, ROWS), SLOTS, x, slot)
    ye = _experts(moe, gather(xe, ("model", None, None)), activation)
    y = constrain(expert_shards(combine, e, (SLOTS,) + (ROWS,) * 3, ROWS,
                                ye, r.gate_w, r.valid, slot), ROWS)

    # load-balance auxiliary (Switch-style), over every token of the chunk
    me = row_mean(r.chosen.float(), (0, 1))
    pe = row_mean(r.probs, (0, 1))
    return y, e * (me * pe).sum()


def moe_apply(moe: MoE, x: torch.Tensor, cfg: MoEConfig, activation: str):
    """x: (B, S, D) -> (y (B, S, D), aux).  The sequence is padded with
    zero tokens to a multiple of the chunk ``min(router_chunk, S)`` and
    routed chunk by chunk (pad tokens take capacity only in the last
    chunk, after every real token); aux is the chunks' mean.  The
    shared and dense FFNs run on the padded input, and the pad is
    sliced off."""
    b, s0, d = x.shape
    cs = min(cfg.router_chunk, s0)
    s = math.ceil(s0 / cs) * cs
    if s != s0:
        x = F.pad(x, (0, 0, 0, s - s0))
    ys, auxs = zip(*(_route_chunk(moe, x[:, i:i + cs], cfg, activation)
                     for i in range(0, s, cs)))
    # one chunk (every decode step) needs no cat and no stack launch
    y = torch.cat(ys, 1) if len(ys) > 1 else ys[0]
    aux = torch.stack(auxs).mean() if len(auxs) > 1 else auxs[0]
    for mlp in (moe.shared, moe.dense):
        if mlp is not None:
            y = y + mlp(x)
    return y[:, :s0], aux
