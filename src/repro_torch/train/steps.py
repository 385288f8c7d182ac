"""Step builders: the train step (loss + gradient + AdamW, optional
microbatch accumulation), the data-parallel train step with int8
gradient compression, the prefill step and the serve step — the port of
``repro/train/steps.py``.

The reference's steps are pure functions of a parameter tree that the
launcher jits (the compressed one under ``shard_map``); here the
parameters live in a ``Model`` and the train steps update them in place
(eager PyTorch, nothing compiled).  The compressed step runs on every
rank of a ``torch.distributed`` mesh, each holding the whole model.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.core.distributed import on_host
from repro_torch.launch.mesh import axis_group
from repro_torch.models import convert
from repro_torch.models import decode as DEC
from repro_torch.models import model as MDL
from repro_torch.models.partitioning import (
    microbatches, reduce_grads_to_params, scan)
from repro_torch.optim import adamw
from repro_torch.optim.compression import mean_in_rank_order, psum_compressed


def build_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    q_chunk: int = 1024,
    accum: int = 1,
    device=None,
    observe: Callable | None = None,
) -> Callable:
    """(model, opt_state, batch) -> (model, opt_state, metrics): the
    model's parameters and the moments updated in place, ``metrics`` the
    loss and MoE aux (device scalars), ``grad_norm`` and ``lr``.

    ``batch`` holds ``labels`` and the model's inputs as tensors or
    NumPy arrays; they go to ``device`` (``None`` is the GPU and raises
    without one), where the model must live.  ``accum`` > 1 splits the
    batch into that many microbatches, accumulates their gradients in
    float32, divides by ``accum`` and averages the metrics.

    Under an activation policy (``partitioning``) each gradient is
    reduced to its parameter's placements as the backward makes it
    (``partitioning.reduce_grads_to_params``, the reference's
    ``grad_shardings``); the float32 microbatch sum and ``/ accum`` keep
    those placements.  ``observe(params, grads)``, where given, is called
    with the two dicts by name that AdamW is about to be handed."""
    device = resolve_device(device)

    def train_step(model, opt_state, batch):
        batch = _on_device(model, batch, device)
        if accum == 1:
            grads, metrics = _grads(model, batch, q_chunk)
        else:
            # a microbatch keeps the batch's sharding under a policy
            parts = {k: microbatches(v, accum) for k, v in batch.items()}
            micro = [{k: parts[k][i] for k in batch} for i in range(accum)]

            def step(i, grads):
                g, m = _grads(model, micro[i], q_chunk)
                return ([gi.float() for gi in g] if grads is None else
                        [a + gi.float() for a, gi in zip(grads, g)]), m

            grads, ms = scan(step, accum)
            grads = [g / accum for g in grads]
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        params = dict(model.named_parameters())
        grads = dict(zip(params, grads))
        if observe is not None:
            observe(params, grads)
        _, opt_state, opt_metrics = adamw.apply_updates(
            opt_cfg, params, grads, opt_state)
        return model, opt_state, {**metrics, **opt_metrics}

    return train_step


def _grads(model, batch: dict, q_chunk: int) -> tuple:
    """Every parameter's gradient of ``loss_fn`` (zeros where a
    parameter is unused) and the metrics.  Under a policy each gradient
    is reduced to its parameter's placements as the backward makes it
    (``partitioning.reduce_grads_to_params``)."""
    params = list(model.parameters())
    with reduce_grads_to_params(params):
        loss, metrics = MDL.loss_fn(model, batch, q_chunk=q_chunk)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return grads, metrics


def _on_device(model, batch: dict, device: torch.device) -> dict:
    """``batch`` on ``device``, which must be the model's."""
    if model.device.type != device.type:
        raise ValueError(f"the model is on {model.device}, the step "
                         f"on {device}")
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def build_compressed_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    mesh,
    data_axes,
    *,
    q_chunk: int = 1024,
    device=None,
) -> Callable:
    """Explicit-DP train step with int8 all-reduce gradient compression
    (error feedback carried in ``opt_state["err"]``, from
    ``compression.init_error``): (model, opt_state, batch) -> (model,
    opt_state, metrics ``loss``, ``aux``, ``grad_norm``, ``lr``).

    Every rank of ``mesh`` holds the whole model and calls the step
    with the same global batch; it takes its rows by its coordinate
    along ``data_axes`` (a mesh axis name or a tuple of them, as
    ``PartitionSpec(data_axes)`` splits the batch under the reference's
    ``shard_map``).  Its gradients go through ``psum_compressed`` over
    the ``data_axes`` group, the loss and aux are meaned over it, and
    AdamW updates the model in place.  Building it creates the group,
    so every rank builds it together.  The model must be on ``device``
    (``None`` is the GPU and raises without one).  A reference leaf
    (a scanned group's layers at one position of its period:
    ``convert.reference_leaves``) is quantized under one scale, as the
    reference's stacked leaves are."""
    device = resolve_device(device)
    group, index, n = axis_group(mesh, data_axes)

    def train_step(model, opt_state, batch):
        batch = _on_device(model, batch, device)
        rows = {v.shape[0] for v in batch.values()}
        if len(rows) != 1 or next(iter(rows)) % n:
            raise ValueError(f"a batch of {sorted(rows)} rows does not "
                             f"split over the {n} ranks of {data_axes}")
        per = next(iter(rows)) // n
        local = {k: v[index * per:(index + 1) * per]
                 for k, v in batch.items()}
        grads, metrics = _grads(model, local, q_chunk)
        # the dict holds the only references, so each reduced leaf
        # replaces its gradient in memory
        grads = dict(zip([name for name, _ in model.named_parameters()],
                         grads))
        grads, err = psum_compressed(
            grads, opt_state["err"], group,
            convert.reference_leaves(cfg, list(grads)))
        keys = sorted(metrics)
        means = mean_in_rank_order(
            torch.stack([metrics[k].float() for k in keys]), group,
            on_host(group, device))
        metrics = dict(zip(keys, means.unbind()))
        _, inner, opt_metrics = adamw.apply_updates(
            opt_cfg, dict(model.named_parameters()), grads,
            {k: opt_state[k] for k in ("m", "v", "step")})
        return model, {**inner, "err": err}, {**metrics, **opt_metrics}

    return train_step


def build_prefill_step(cfg: ModelConfig, *, q_chunk: int = 1024) -> Callable:
    """(model, batch) -> ``decode.prefill``'s (last-token logits, cache)
    over ``tokens`` or ``embeds`` (and an encoder–decoder's
    ``enc_embeds``)."""
    def prefill_step(model, batch):
        return DEC.prefill(
            model,
            batch.get("tokens"),
            embeds=batch.get("embeds"),
            enc_embeds=batch.get("enc_embeds"),
            q_chunk=q_chunk,
        )

    return prefill_step


def build_serve_step(cfg: ModelConfig) -> Callable:
    """(model, cache, tokens) -> ``decode.decode_step``'s (logits,
    cache)."""
    def serve_step(model, cache, tokens):
        return DEC.decode_step(model, cache, tokens)

    return serve_step
