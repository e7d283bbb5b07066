"""Learning-rate schedules (pure functions of the step counter)."""

from __future__ import annotations

import numpy as np

__all__ = ["warmup_cosine"]


def warmup_cosine(step: int, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> float:
    """Linear warmup to ``peak_lr``, then cosine decay to
    ``final_frac * peak_lr`` at ``total_steps``.  Computed in float32 on
    the host, as the reference computes it on its int32 step; returns a
    Python float, so the training loop never waits on the device for it."""
    f = np.float32
    step = f(step)
    warm = f(peak_lr) * step / f(max(warmup_steps, 1))
    t = (step - f(warmup_steps)) / f(max(total_steps - warmup_steps, 1))
    t = np.clip(t, f(0.0), f(1.0))
    # the reference's Python-float subexpression (1 - final_frac) * 0.5 is
    # folded in double before it meets float32, so it is here too
    cos = f(peak_lr) * (f(final_frac) + f((1 - final_frac) * 0.5)
                        * (f(1) + np.cos(f(np.pi) * t)))
    return float(warm if step < warmup_steps else cos)
