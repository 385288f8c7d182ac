"""AdamW with global-norm clipping and a configurable moment dtype — the
port of ``repro/optim/adamw.py``.

Parameters, gradients and moments are dicts of named tensors (a model's
``named_parameters()``).  The update follows the reference's rounding
order: float32 squares for the global norm, the learning rate and the
bias corrections as float32 scalars, weight decay added to the update,
moments and parameters computed in float32 and cast back.  It writes
the parameters and moments in place (under ``no_grad``), so a model
keeps its parameters.  ``torch.optim.AdamW`` orders its arithmetic
differently and is not used.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str | None = None      # None -> same as param
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> np.float32:
    """Linear warmup + cosine decay at ``step``, in float32 on the host
    (the reference's float32 scalar arithmetic; no device launch)."""
    f32 = np.float32
    step = f32(step)
    warm = np.minimum(f32(1.0),
                      (step + f32(1)) / f32(max(1, cfg.warmup_steps)))
    t = np.clip((step - f32(cfg.warmup_steps))
                / f32(max(1, cfg.total_steps - cfg.warmup_steps)),
                f32(0.0), f32(1.0))
    cos = f32(cfg.min_lr_frac) + f32(1 - cfg.min_lr_frac) * f32(0.5) * (
        f32(1) + np.cos(f32(np.pi) * t))
    return f32(cfg.lr) * warm * cos


def init_state(cfg: AdamWConfig, params: dict) -> dict:
    """Zero moments ``m``, ``v`` (``cfg.state_dtype``, or each
    parameter's dtype) beside each parameter, placed as it is (a DTensor
    parameter's moments are DTensors of its placements), and ``step`` 0
    (a host int)."""
    def moment(p):
        dt = getattr(torch, cfg.state_dtype) if cfg.state_dtype else p.dtype
        return torch.zeros_like(p, dtype=dt,
                                memory_format=torch.contiguous_format,
                                requires_grad=False)

    return {"m": {n: moment(p) for n, p in params.items()},
            "v": {n: moment(p) for n, p in params.items()},
            "step": 0}


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """One AdamW step -> (params, state, metrics ``grad_norm`` (a device
    scalar, before clipping) and ``lr`` (float32)); ``params`` and the
    moments are updated in place and returned."""
    gnorm = torch.stack([g.float().square().sum()
                         for g in grads.values()]).sum().sqrt()
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(step))
    b2c = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(step))
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
        u = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - float(lr) * u)
        m.copy_(m32)
        v.copy_(v32)
    state = {"m": state["m"], "v": state["v"], "step": step}
    return params, state, {"grad_norm": gnorm, "lr": lr}
