"""Train a reduced-config LM for a few hundred steps with checkpointing
and (optional) failure injection + recovery, on the PyTorch/CUDA port
(the counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --fail-at 90  # dies
    PYTHONPATH=src python examples/torch_train_lm.py --restore     # resumes

``--device`` defaults to the GPU and raises without one; ``--device
cpu`` trains on the CPU.  The checkpoints go to ``--checkpoint-dir``
(by default ``repro_torch_ckpt`` in the temporary directory).
"""
import argparse
import os
import tempfile

from repro_torch.configs.registry import ARCH_IDS, get_reduced
from repro_torch.optim import adamw
from repro_torch.train.loop import FailureInjector, Trainer, TrainerConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args()

    cfg = get_reduced(args.arch)
    tcfg = TrainerConfig(steps=args.steps, seq_len=64, global_batch=8,
                         checkpoint_every=50,
                         checkpoint_dir=args.checkpoint_dir, q_chunk=64,
                         log_every=20)
    trainer = Trainer(cfg, tcfg,
                      adamw.AdamWConfig(lr=3e-3, warmup_steps=20,
                                        total_steps=args.steps),
                      device=args.device)
    injector = FailureInjector(args.fail_at) if args.fail_at else None
    _, hist = trainer.run(injector=injector, restore=args.restore)
    if hist:
        print(f"loss {hist[0]:.3f} -> {hist[-1]:.3f} over {len(hist)} steps")
    else:
        print(f"no step to run: the restored checkpoint is at step "
              f"{args.steps} or later")


if __name__ == "__main__":
    main()
