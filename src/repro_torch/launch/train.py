"""Training driver: data pipeline + train step + fault tolerance.

Runs on the CUDA card (``--device cuda``, the default; raises without
one) or on the CPU (``--device cpu``).  With ``--ckpt-dir`` the loop runs
under ``FaultTolerantRunner`` with async checkpoints and resumes from the
newest one; ``--full`` trains the architecture's full config instead of
its smoke config.  Weights are random, drawn from ``--seed``; data is a
``MarkovTask`` of the same seed.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --steps 60 --batch 8 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 5 \\
      --batch 4 --seq 1024
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs as cfgs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import MarkovTask
from repro_torch.distributed.fault import FaultTolerantRunner
from repro_torch.models import LM, init_params
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.train import make_train_step

__all__ = ["train_loop", "main"]


def train_loop(arch: str, *, smoke: bool = True, steps: int = 100,
               batch: int = 8, seq: int = 64, ckpt_dir: str | None = None,
               peak_lr: float = 3e-3, accum: int = 1, log_every: int = 10,
               seed: int = 0, fault_hook=None,
               device: str | torch.device = "cuda"):
    """Train ``arch`` for ``steps`` steps; returns ((params, opt_state),
    the losses of the logged steps, the data task).  ``fault_hook(step)``
    runs at the start of every step under the checkpointing runner (it
    may raise to simulate a failure)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card available; pass device='cpu'")
    cfg = cfgs.get_smoke_config(arch) if smoke else cfgs.get_config(arch)
    model = LM(cfg)
    task = MarkovTask(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=seed)
    lr = lambda s: warmup_cosine(s, peak_lr=peak_lr,
                                 warmup_steps=steps // 10 + 1,
                                 total_steps=steps)
    opt = adamw(lr)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device)
    opt_state = opt.init(params)
    # Donated whenever the optimizer has an update_, as the reference jits
    # its step with donate_argnums=(0, 1): 12 B a parameter at the peak, not
    # 24.  fault_hook raises before step_fn, so an injected fault sees a
    # whole state.  A step that fails inside update_ leaves the state half
    # written; the runner drops it for the newest checkpoint (save_async
    # copied every leaf to the host before its thread started, so none is
    # half written) and replays from that step, as the reference must,
    # whose donated buffers are gone after a failed call.
    step_fn = make_train_step(model, opt, accum_steps=accum,
                              donate=opt.update_ is not None)

    losses: list[float] = []

    def one_step(state, step):
        params, opt_state = state
        params, opt_state, metrics = step_fn(params, opt_state,
                                             task.batch(step, device), step)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"[train {arch}] step {step:5d} loss {loss:.4f} "
                  f"lr {metrics['lr']:.2e}")
        return (params, opt_state)

    # the loop holds the only reference to the state, which the donated
    # step updates in place (a pure step's old copy is freed as the next
    # one replaces it)
    state = (params, opt_state)
    del params, opt_state
    if ckpt_dir is not None:
        manager = CheckpointManager(ckpt_dir, keep=3)
        runner = FaultTolerantRunner(one_step, manager,
                                     checkpoint_every=max(steps // 4, 10))
        start = manager.latest_step() or 0
        if start:
            start, state = manager.restore_latest(state)
            print(f"[train {arch}] resumed from step {start}")
        handoff = [state]
        del state
        state, report = runner.run(handoff.pop(), start, steps - start,
                                   fault_hook=fault_hook)
        print(f"[train {arch}] done: {report.steps_run} steps, "
              f"{report.failures_recovered} recoveries, "
              f"{report.checkpoints_written} checkpoints")
    else:
        for step in range(steps):
            state = one_step(state, step)
    return state, losses, task


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=cfgs.TOKEN_ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    t0 = time.time()
    state, losses, task = train_loop(
        args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
        seq=args.seq, ckpt_dir=args.ckpt_dir, accum=args.accum,
        peak_lr=args.lr, seed=args.seed, device=args.device)
    print(f"[train] first loss {losses[0]:.3f} -> last {losses[-1]:.3f} "
          f"(markov entropy floor {task.entropy_floor_nats:.3f} nats) "
          f"in {time.time()-t0:.0f}s")
    return state, losses


if __name__ == "__main__":
    main()
