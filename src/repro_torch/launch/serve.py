"""Serving launcher: batched prefill + greedy decode against a cache
(k/v for attention, a fixed-size state for the recurrent layers, the
encoder output's cross k/v for an encoder–decoder) for every
architecture — attention (dense or MoE), zamba2's hybrid Mamba2 stack,
xLSTM, seamless-m4t's encoder–decoder — the port of
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        [--reduced] --batch 4 --prompt-len 32 --gen 16 [--device cuda]

The recurrent layers scan the prompt in chunks of 128 tokens, so for
zamba2-7b and xlstm-350m ``--prompt-len`` is at most 128 or a multiple
of it.

``--device`` defaults to the GPU and raises without one; ``--device
cpu`` runs on the CPU.  Weights are drawn from seed 0 on the device
into the activation dtype, which the server then holds (each parameter
drawn in its master dtype and cast, so no master copy of the whole
model is made); the prompt is drawn from numpy seed 0, as the
reference's, and an encoder–decoder's encoder input is ``--prompt-len``
frames of the audio frontend stub drawn after it.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, get_reduced
from repro_torch.core.backend import resolve_device
from repro_torch.models import decode as DEC
from repro_torch.models import model as MDL


def load_model(cfg: ModelConfig, device=None, seed: int = 0) -> MDL.Model:
    """The served model in ``cfg.activation_dtype``, drawn on ``device``
    (``None`` is the GPU) from ``seed``: equal to the masters drawn from
    the same seed and cast, without holding them (deepseek-moe-16b's
    float32 masters alone are 67.5 GB)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return MDL.init_params(cfg, gen, device, dtype=cfg.activation_dtype)


def prompt_inputs(cfg: ModelConfig, batch: int, prompt_len: int, device,
                  seed: int = 0) -> dict:
    """Seeded prompt tokens (B, S), or frame/patch embeddings (B, S, D)
    for a vision frontend (the modality stub), and an encoder–decoder's
    ``enc_embeds`` (B, S, D), as ``prefill`` keywords: the reference
    launcher's draws, in its order."""
    rng = np.random.default_rng(seed)

    def frames():
        return torch.from_numpy(rng.standard_normal(
            (batch, prompt_len, cfg.d_model), dtype=np.float32)).to(device)

    tokens = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    kw = ({"embeds": frames()} if cfg.frontend == "vision"
          else {"tokens": torch.from_numpy(tokens).to(device)})
    if cfg.is_enc_dec:
        kw["enc_embeds"] = frames()
    return kw


def decode(model: MDL.Model, cache: dict, tok: torch.Tensor, steps: int):
    """``steps`` greedy decode steps from ``tok`` (B, 1) -> (the tokens
    fed (B, steps), the last step's logits).  Nothing is read back to
    the host."""
    fed = []
    logits = None
    for _ in range(steps):
        fed.append(tok)
        logits, cache = DEC.decode_step(model, cache, tok)
        tok = logits.argmax(-1)
    return torch.cat(fed, 1), logits


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="prompt tokens; for the recurrent layer kinds "
                         "(zamba2-7b, xlstm-350m) at most 128 or a "
                         "multiple of 128 (their chunked scan)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = load_model(cfg, device)
    b, s = args.batch, args.prompt_len
    inputs = prompt_inputs(cfg, b, s, device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = DEC.prefill(model, smax=s + args.gen, q_chunk=min(128, s),
                                **inputs)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    t0 = time.perf_counter()
    out, logits = decode(model, cache, logits.argmax(-1), args.gen)
    _sync(device)
    t_decode = time.perf_counter() - t0

    print(f"arch={cfg.name} batch={b} prompt={s} gen={args.gen} "
          f"device={device}")
    print(f"prefill: {t_prefill*1e3:.1f} ms   decode: "
          f"{t_decode/args.gen*1e3:.2f} ms/token "
          f"({b*args.gen/t_decode:.1f} tok/s)")
    print("sample token ids:", out[0, :10].cpu().numpy())


if __name__ == "__main__":
    main()
