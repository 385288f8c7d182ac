"""Training launcher — the port of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --reduced --steps 200 --checkpoint-dir CKPT [--restore] \\
        [--fail-at 50] [--device cpu]

``--device`` defaults to the GPU and raises without one; ``--device
cpu`` runs on the CPU (use ``--reduced`` there).  ``--fail-at N``
injects a node failure at step N: rerun with ``--restore`` to resume
from the latest atomic checkpoint.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.registry import ARCH_IDS, get_config, get_reduced
from repro_torch.train.loop import FailureInjector, Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=20)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    tcfg = TrainerConfig(
        steps=args.steps, seq_len=args.seq_len,
        global_batch=args.global_batch,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        q_chunk=min(128, args.seq_len),
    )
    trainer = Trainer(cfg, tcfg, device=args.device)
    injector = FailureInjector(args.fail_at) if args.fail_at else None
    state, history = trainer.run(injector=injector, restore=args.restore)
    if history:
        print(f"final loss: {history[-1]:.4f} (from {history[0]:.4f})")
    else:
        print(f"no step to run: the restored checkpoint is at step "
              f"{args.steps} or later")
    return state, history


if __name__ == "__main__":
    main()
