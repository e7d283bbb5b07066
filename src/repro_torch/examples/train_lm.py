"""End-to-end driver: train a ~100M-parameter LM for a few hundred steps.

The twin of the reference's ``examples/train_lm.py``: the xlstm-125m
architecture at FULL width and depth (196M parameters with embeddings)
on the deterministic Markov task, AdamW at a peak learning rate of 1e-3,
with checkpointing and the fault-tolerant runner — the complete
production loop.  Checkpoints go to ``--ckpt-dir`` (``build/train_lm``
under the working directory by default).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
      [--device cpu] [--smoke]
(on the CPU use --smoke or --steps 30 for a quick look — the loss
visibly decreases within ~20 steps.)
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.launch.train import train_loop

ARCH = "xlstm-125m"
PEAK_LR = 1e-3


def train(*, steps: int = 200, batch: int = 8, seq: int = 128,
          ckpt_dir: str | None = "build/train_lm", smoke: bool = False,
          device: str | torch.device = "cuda", log_every: int = 10,
          fault_hook=None):
    """``train_loop`` at the example's settings; returns ((params,
    opt_state), the losses logged every ``log_every`` steps and at the
    last, the data task)."""
    return train_loop(ARCH, smoke=smoke, steps=steps, batch=batch, seq=seq,
                      ckpt_dir=ckpt_dir, peak_lr=PEAK_LR,
                      log_every=log_every, fault_hook=fault_hook,
                      device=device)


def main(argv: list[str] | None = None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="build/train_lm")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config instead of the full 125M")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, losses, task = train(steps=args.steps, batch=args.batch,
                            seq=args.seq, ckpt_dir=args.ckpt_dir,
                            smoke=args.smoke, device=args.device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(task entropy floor {task.entropy_floor_nats:.3f} nats)")
    assert losses[-1] < losses[0], "training must reduce loss"
    return losses


if __name__ == "__main__":
    main()
