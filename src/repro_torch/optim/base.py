"""Optimizer interface: pure (init, update) pairs over parameter trees.

A parameter tree is nested dicts of tensors (``repro_torch.models.
params``).  Updates are deltas added to the parameters, as in the
reference; nothing is updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.params import leaves, map_tree

__all__ = ["Optimizer", "global_norm_clip", "clip_scale", "apply_updates"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init(params) -> state;  update(grads, state, params, step) ->
    (updates, new_state, metrics).  Updates are *deltas* added to params;
    ``step`` is a Python int."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple[Any, Any, dict]]


def clip_scale(grads: Any, max_norm: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the factor min(1, max_norm / |grads|), the global L2 norm |grads|),
    both 0-d tensors on the grads' device."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for _, g in leaves(grads)))
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0), gn


def global_norm_clip(grads: Any, max_norm: float
                     ) -> tuple[Any, torch.Tensor]:
    """Scale ``grads`` so that their global L2 norm is at most
    ``max_norm``.  Returns (clipped grads, the norm before clipping); the
    norm stays on the grads' device."""
    scale, gn = clip_scale(grads, max_norm)
    return map_tree(lambda g: (g * scale).to(g.dtype), grads), gn


def apply_updates(params: Any, updates: Any) -> Any:
    """params + updates, added in float32 and stored in each param's dtype."""
    return map_tree(
        lambda p, u: (p.to(torch.float32) + u.to(torch.float32)).to(p.dtype),
        params, updates)
