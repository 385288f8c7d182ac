"""Step builders: the train step (loss + gradient + AdamW, optional
microbatch accumulation), the prefill step and the serve step — the
port of ``repro/train/steps.py``.

The reference's steps are pure functions of a parameter tree that the
launcher jits; here the parameters live in a ``Model`` and the train
step updates them in place (eager PyTorch, nothing compiled).
``build_compressed_train_step`` (int8 all-reduce with error feedback
over data-parallel ranks) is not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.models import decode as DEC
from repro_torch.models import model as MDL
from repro_torch.optim import adamw


def build_train_step(
    cfg: ModelConfig,
    opt_cfg: adamw.AdamWConfig,
    *,
    q_chunk: int = 1024,
    accum: int = 1,
    device=None,
) -> Callable:
    """(model, opt_state, batch) -> (model, opt_state, metrics): the
    model's parameters and the moments updated in place, ``metrics`` the
    loss and MoE aux (device scalars), ``grad_norm`` and ``lr``.

    ``batch`` holds ``labels`` and the model's inputs as tensors or
    NumPy arrays; they go to ``device`` (``None`` is the GPU and raises
    without one), where the model must live.  ``accum`` > 1 splits the
    batch into that many microbatches, accumulates their gradients in
    float32, divides by ``accum`` and averages the metrics."""
    device = resolve_device(device)

    def grads_of(model, batch):
        params = list(model.parameters())
        loss, metrics = MDL.loss_fn(model, batch, q_chunk=q_chunk)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return grads, metrics

    def train_step(model, opt_state, batch):
        if model.device.type != device.type:
            raise ValueError(f"the model is on {model.device}, the step "
                             f"on {device}")
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        if accum == 1:
            grads, metrics = grads_of(model, batch)
        else:
            micro = [{k: v[i * (v.shape[0] // accum):
                            (i + 1) * (v.shape[0] // accum)]
                      for k, v in batch.items()} for i in range(accum)]
            grads, ms = None, []
            for mb in micro:
                g, m = grads_of(model, mb)
                grads = ([gi.float() for gi in g] if grads is None else
                         [a + gi.float() for a, gi in zip(grads, g)])
                ms.append(m)
            grads = [g / accum for g in grads]
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        names = [n for n, _ in model.named_parameters()]
        _, opt_state, opt_metrics = adamw.apply_updates(
            opt_cfg, dict(model.named_parameters()), dict(zip(names, grads)),
            opt_state)
        return model, opt_state, {**metrics, **opt_metrics}

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
