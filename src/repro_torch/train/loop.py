"""Training loop with checkpoint/restart fault tolerance — the port of
``repro/train/loop.py``.

Fault model: a node failure kills the process; on restart the loop
restores the latest atomic checkpoint and replays the deterministic data
stream from the restored step, so the state after recovery equals an
uninterrupted run's bit for bit (``tests/test_torch_trainer.py``, with
injected failures).  Batches are pure functions of (seed, step, shard),
and a checkpoint restores onto the template's device, whichever device
wrote it.

The state is ``{"params": model, "opt": AdamW state}``: the model holds
the parameters, which the eager train step updates in place; a
checkpoint stores ``{"params": {name: tensor}, "opt": ...}``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.backend import resolve_device
from repro_torch.data.synthetic import EmbedPipeline, TokenPipeline
from repro_torch.models import model as MDL
from repro_torch.optim import adamw
from repro_torch.train.steps import build_train_step


class FailureInjector:
    """Raises at a chosen step — simulates a node dying mid-run."""

    def __init__(self, fail_at_step: int | None = None):
        self.fail_at_step = fail_at_step
        self.fired = False

    def maybe_fail(self, step: int):
        if (self.fail_at_step is not None and step == self.fail_at_step
                and not self.fired):
            self.fired = True
            raise RuntimeError(f"injected node failure at step {step}")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    checkpoint_every: int = 20
    checkpoint_dir: str | None = None
    q_chunk: int = 128
    seed: int = 0
    log_every: int = 10


def checkpoint_tree(state: dict) -> dict:
    """What a checkpoint stores of a state: the parameters by name and
    the optimizer state."""
    return {"params": {n: p.detach()
                       for n, p in state["params"].named_parameters()},
            "opt": state["opt"]}


class Trainer:
    """Eager train steps from the synthetic pipeline on ``device``
    (``None`` is the GPU and raises without one), a checkpoint every
    ``checkpoint_every`` steps and at the end, and restore-and-resume."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainerConfig,
                 opt_cfg: adamw.AdamWConfig | None = None, device=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            lr=1e-3, warmup_steps=10, total_steps=tcfg.steps)
        if cfg.frontend in ("audio", "vision") and not cfg.is_enc_dec:
            self.pipeline: Any = EmbedPipeline(
                cfg.d_model, tcfg.seq_len, tcfg.global_batch,
                cfg.vocab_size, tcfg.seed)
        else:
            self.pipeline = TokenPipeline(
                cfg.vocab_size, tcfg.seq_len, tcfg.global_batch, tcfg.seed)
        self.step_fn = build_train_step(cfg, self.opt_cfg,
                                        q_chunk=tcfg.q_chunk,
                                        device=self.device)
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir)
                     if tcfg.checkpoint_dir else None)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0) -> dict:
        """The masters drawn from ``seed`` on the trainer's device, and
        zero AdamW moments."""
        gen = torch.Generator(self.device).manual_seed(seed)
        model = MDL.init_params(self.cfg, gen, self.device)
        opt = adamw.init_state(self.opt_cfg, dict(model.named_parameters()))
        return {"params": model, "opt": opt}

    def batch(self, step: int) -> dict:
        """The pipeline's batch for ``step`` (NumPy), with an
        encoder–decoder's ``enc_embeds`` drawn from ``[seed, step, 11]``
        as the reference's."""
        out = dict(self.pipeline.batch(step))
        if self.cfg.is_enc_dec:
            rng = np.random.default_rng([self.tcfg.seed, step, 11])
            out["enc_embeds"] = rng.standard_normal(
                (self.tcfg.global_batch, self.tcfg.seq_len,
                 self.cfg.d_model), dtype=np.float32)
        return out

    def restore(self, state: dict) -> tuple[dict, int]:
        """The latest checkpoint loaded into ``state`` (the model's
        parameters replaced) -> (state, the step to resume at)."""
        tree, _, step = self.ckpt.restore(checkpoint_tree(state))
        model = state["params"]
        model.load_state_dict(tree["params"], assign=True)
        return {"params": model, "opt": tree["opt"]}, step

    # ------------------------------------------------------------------
    def run(self, state=None, start_step: int = 0,
            injector: FailureInjector | None = None,
            restore: bool = False):
        """Run to tcfg.steps; returns (state, loss history).  With
        restore=True, resumes from the latest checkpoint if present."""
        if restore and self.ckpt and self.ckpt.latest_step() is not None:
            state, start_step = self.restore(state or self.init_state())
        elif state is None:
            state = self.init_state()

        history = []
        for step in range(start_step, self.tcfg.steps):
            if injector:
                injector.maybe_fail(step)
            model, opt, metrics = self.step_fn(
                state["params"], state["opt"], self.batch(step))
            state = {"params": model, "opt": opt}
            loss = float(metrics["loss"])
            history.append(loss)
            if self.ckpt and (step + 1) % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, checkpoint_tree(state))
            if step % self.tcfg.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f}")
        if self.ckpt:
            self.ckpt.save(self.tcfg.steps, checkpoint_tree(state))
            self.ckpt.wait()
        return state, history
