"""AdamW (decoupled weight decay), fp32 moments, schedule-aware."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.models.params import map_tree
from repro_torch.optim.base import (Optimizer, add_update, chunks,
                                    clip_scale)

__all__ = ["adamw"]


def adamw(lr: Callable | float, *, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float = 1.0) -> Optimizer:
    """AdamW over a parameter tree; ``lr`` is a constant or a schedule of
    the step.  The step's learning rate and bias corrections are host
    floats computed in float32, as the reference computes them on its
    int32 step counter; the moments and updates stay on the device.
    Clipping scales each gradient leaf inside its own update, as the
    reference's ``global_norm_clip`` scales it, so no clipped copy of the
    whole gradient tree is held.  ``update_`` is the donated step: the
    same arithmetic, written into the state and the parameters one chunk
    of a leaf at a time."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return {"m": map_tree(zeros, params), "v": map_tree(zeros, params)}

    def prepare(grads, step: int):
        """The step's clip factor, gradient norm, learning rate and bias
        corrections."""
        scale, gn = clip_scale(grads, clip_norm) if clip_norm else (None,
                                                                     None)
        t = np.float32(step) + np.float32(1.0)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        if gn is None:
            gn = torch.zeros(())
        return scale, gn, float(lr_fn(step)), bc1, bc2

    def upd(g, m, v, p, scale, lr_t, bc1, bc2):
        if scale is not None:
            g = (g * scale).to(g.dtype)
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = -(lr_t * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                      + weight_decay * p.to(torch.float32)))
        return u, m, v

    def update(grads, state, params, step: int):
        scale, gn, lr_t, bc1, bc2 = prepare(grads, step)
        flat = map_tree(lambda g, m, v, p: upd(g, m, v, p, scale, lr_t, bc1,
                                               bc2),
                        grads, state["m"], state["v"], params)
        pick = lambda i: map_tree(lambda x: x[i], flat)
        return pick(0), {"m": pick(1), "v": pick(2)}, {"grad_norm": gn,
                                                       "lr": lr_t}

    def update_(grads, state, params, step: int):
        scale, gn, lr_t, bc1, bc2 = prepare(grads, step)

        def one(g, m, v, p):
            for gc, mc, vc, pc in chunks(g, m, v, p):
                u, m_new, v_new = upd(gc, mc, vc, pc, scale, lr_t, bc1, bc2)
                mc.copy_(m_new)
                vc.copy_(v_new)
                pc.copy_(add_update(pc, u))

        map_tree(one, grads, state["m"], state["v"], params)
        return {"grad_norm": gn, "lr": lr_t}

    return Optimizer(init=init, update=update, update_=update_)
