"""Optimizers (no dependency beyond torch).

  adamw       — AdamW with fp32 state and global-norm clipping
  schedules   — linear-warmup cosine decay

The reference's ``adafactor`` and its int8 error-feedback gradient
``compression`` are not ported yet (``ROADMAP.md``).
"""

from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import Optimizer, apply_updates, global_norm_clip
from repro_torch.optim.schedules import warmup_cosine

__all__ = ["Optimizer", "adamw", "warmup_cosine", "apply_updates",
           "global_norm_clip"]
