"""Optimizers and distributed-optimization tricks (no dependency beyond
torch).

  adamw       — AdamW with fp32 state and global-norm clipping
  adafactor   — factored second moment (state ~ O(rows + cols))
  schedules   — linear-warmup cosine decay
  compression — int8 error-feedback gradient compression (cross-pod link)
"""

from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.base import Optimizer, apply_updates, global_norm_clip
from repro_torch.optim.compression import (ef_compress, ef_decompress,
                                           ef_init, ef_scale)
from repro_torch.optim.schedules import warmup_cosine

__all__ = ["Optimizer", "adamw", "adafactor", "warmup_cosine",
           "apply_updates", "global_norm_clip", "ef_init", "ef_compress",
           "ef_decompress", "ef_scale"]
