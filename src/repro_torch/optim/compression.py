"""int8 gradient compression with error feedback — the port of
``repro/optim/compression.py``.

Each data-parallel rank quantizes a gradient leaf to int8 with one
float32 scale (the quantization residual carried over to the next step
as the error, Karimireddy et al. 2019), the ranks sum the payloads as
int32 and mean the scales, and each rank dequantizes the sum.  As in
the reference the payload goes on the wire as int32, 4 bytes a
parameter: the same volume as float32, not the int8 cut its docstring
claims.

``quantize`` keeps the reference's arithmetic and order, so its outputs
equal the reference's bit for bit.  A reference leaf stacks the layers
of a scanned group under one scale; the port's layers are tensors of
their own, so ``psum_compressed`` takes the groups of names that share
a scale.  The scales are all-gathered and summed in group rank order
(a backend's all-reduce may sum them in another order, and float32
addition does not associate).  A gloo group carries a CUDA tensor
through host buffers; an NCCL group takes CUDA tensors only.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.distributed import on_host


def init_error(params: dict) -> dict:
    """Float32 zeros beside each named parameter."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()}


def _absmax(g: torch.Tensor, err: torch.Tensor) -> torch.Tensor:
    return (g.float() + err).abs().max()


def _round(g: torch.Tensor, err: torch.Tensor, scale: torch.Tensor):
    """(int8 payload, new error) of ``g`` plus ``err`` at ``scale``."""
    g32 = g.float() + err
    q = torch.round(g32 / scale).clamp_(-127, 127).to(torch.int8)
    return q, g32.sub_(q.float() * scale)


def quantize(g: torch.Tensor, err: torch.Tensor):
    """Returns (int8 payload, scale, new_error)."""
    scale = _absmax(g, err) / 127.0 + 1e-30
    q, new_err = _round(g, err, scale)
    return q, scale, new_err


def _all_reduce(x: torch.Tensor, group, host: bool) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (through the host when ``host``)."""
    wire = x.cpu() if host else x
    dist.all_reduce(wire, dist.ReduceOp.SUM, group=group)
    return wire.to(x.device) if host else wire


def mean_in_rank_order(x: torch.Tensor, group, host: bool) -> torch.Tensor:
    """The mean of ``x`` over ``group``: the ranks' values gathered and
    summed left to right in group rank order, then divided by the group
    size — the same float32 result on every rank and every backend."""
    n = dist.get_world_size(group)
    wire = (x.cpu() if host else x).reshape(-1)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return (total / n).reshape(x.shape).to(x.device)


def psum_compressed(grads: dict, errors: dict, group=None, leaves=None):
    """Quantize and reduce each gradient leaf over ``group`` (None: the
    default group) -> (mean gradients in float32, new errors).

    int8 payloads are accumulated in int32 (no overflow up to 2^24
    ranks), scales are meaned.  ``leaves`` lists the names that share
    one scale, as the reference's stacked leaves do (one leaf holds a
    scanned group of layers: ``convert.reference_leaves``); None gives
    each tensor its own.  A leaf's scale comes from a first pass over
    its tensors, then each tensor is quantized, reduced and replaced in
    ``grads`` and ``errors`` in turn (the dicts given are updated and
    returned), so a step holds one tensor's temporaries beside them,
    not a second copy of either."""
    leaves = [[name] for name in grads] if leaves is None else leaves
    if sorted(n for leaf in leaves for n in leaf) != sorted(grads):
        raise ValueError("leaves must hold every gradient's name once")
    n = dist.get_world_size(group)
    for leaf in leaves:
        host = on_host(group, grads[leaf[0]].device)
        scale = torch.stack([_absmax(grads[name], errors[name])
                             for name in leaf]).max() / 127.0 + 1e-30
        mean = mean_in_rank_order(scale, group, host)
        for name in leaf:
            g, grads[name] = grads[name], None
            q, errors[name] = _round(g, errors[name], scale)
            del g
            acc = _all_reduce(q.to(torch.int32), group, host)
            del q
            grads[name] = acc.float() * mean / n
    return grads, errors
