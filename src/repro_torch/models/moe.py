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
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import MLP, normal_init_, param
from repro_torch.models.partitioning import constrain, on_replicas, replicate


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
    probs = torch.softmax(replicate(x.float() @ router.float()), dim=-1)
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
    # expert hidden: F rides the batch axes (the weights' sharding)
    h = constrain(h, ("model", None, "batch"))
    return constrain(torch.bmm(h, moe.down), ("model", None, None))


def _route_chunk(moe: MoE, x: torch.Tensor, cfg: MoEConfig,
                 activation: str):
    """x: (B, Cs, D) -> (B, Cs, D) through the routed experts, aux."""
    b, cs, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cs * k / e, cfg.capacity_factor)
    # under a policy the routing, the dispatch scatter and the combine
    # gather run replicated: DTensor has no rule for the in-place
    # scatters (the dispatch's ``index_copy_`` runs on each replica)
    x = replicate(x)
    gate_idx, gate_w, pos, valid, probs, chosen = route(x, moe.router, cfg)

    # slot (e, b, c) is row e·B·C + b·C + c of the (E, B·C, D) expert
    # input; a dropped assignment writes the one spare row past the end
    rows = torch.arange(b, device=x.device).view(b, 1, 1) * cap
    slot = gate_idx * (b * cap) + rows + pos
    slot = torch.where(valid, slot, e * b * cap).reshape(-1)

    def dispatch(x, slot):
        xe = x.new_zeros((e * b * cap + 1, d))
        xe.index_copy_(0, slot,
                       x.unsqueeze(2).expand(b, cs, k, d).reshape(-1, d))
        return xe[:-1].view(e, b * cap, d)

    xe = constrain(on_replicas(dispatch, x, slot), ("model", None, None))
    ye = _experts(moe, xe, activation)

    # combine: the weights cast to the activation dtype before the sum
    # over K, as the reference's combine tensor is; a dropped
    # assignment weighs 0 (its slot index is kept in range)
    w = torch.where(valid, gate_w, 0.0).to(x.dtype).reshape(b * cs, 1, k)
    yk = replicate(ye).reshape(e * b * cap, d)[slot.clamp_max(e * b * cap - 1)]
    y = constrain(torch.bmm(w, yk.view(b * cs, k, d)).view(b, cs, d),
                  ("batch", None, None))

    # load-balance auxiliary (Switch-style), over every token of the chunk
    me = chosen.float().mean((0, 1))
    pe = probs.mean((0, 1))
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
