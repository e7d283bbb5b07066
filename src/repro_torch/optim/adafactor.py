"""Adafactor (Shazeer & Stern 2018): factored second moment, no momentum.

The optimizer-state footprint is O(rows + cols) per matrix instead of
O(rows * cols).  Update-RMS clipping (d=1.0) replaces global-norm
clipping.  The twin of the reference's ``repro.optim.adafactor``; its
state is the reference's tree, ``{"v": tree of {"vr", "vc"} | {"v"}}``
with float32 leaves, so ``convert.adafactor_state_from_numpy`` carries a
reference state over.  The reference uses it only in its dry run;
``launch.train`` trains with AdamW, as the reference's ``train_loop``
does.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.models.params import map_tree
from repro_torch.optim.base import Optimizer

__all__ = ["adafactor"]


def adafactor(lr: Callable | float, *, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0,
              min_dim_size_to_factor: int = 128) -> Optimizer:
    """Adafactor over a parameter tree; ``lr`` is a constant or a schedule
    of the step.  A leaf is factored when its last two dims are both at
    least ``min_dim_size_to_factor``.  The step's decay
    ``beta = 1 - t^-decay`` (t = step + 1) is a host float computed in
    float32, as the reference computes it on its int32 step counter."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor \
            and shape[-2] >= min_dim_size_to_factor

    def init(params):
        def one(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if factored(p.shape):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"v": map_tree(one, params)}

    def update(grads, state, params, step: int):
        f = np.float32
        t = f(step) + f(1.0)
        beta32 = f(1.0) - t ** f(-decay)
        beta, one_minus = float(beta32), float(f(1.0) - beta32)
        lr_t = float(lr_fn(step))

        def one(g, s, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if factored(g.shape):
                vr = beta * s["vr"] + one_minus * g2.mean(dim=-1)
                vc = beta * s["vc"] + one_minus * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True)
                u = g * (torch.rsqrt(vr / torch.clamp(denom, min=eps))[
                    ..., None] * torch.rsqrt(vc)[..., None, :])
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + one_minus * g2
                u = g * torch.rsqrt(v)
                ns = {"v": v}
            rms_u = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            upd = -lr_t * u
            if weight_decay:
                upd = upd - lr_t * weight_decay * p.to(torch.float32)
            return upd, ns

        flat = map_tree(one, grads, state["v"], params)
        pick = lambda i: map_tree(lambda x: x[i], flat)
        return pick(0), {"v": pick(1)}, {"lr": lr_t}

    return Optimizer(init=init, update=update)
