"""Optimizer interface: pure (init, update) pairs over parameter trees.

A parameter tree is nested dicts of tensors (``repro_torch.models.
params``).  Updates are deltas added to the parameters, as in the
reference; ``update`` updates nothing in place.  An optimizer may also
offer ``update_``, the step on donated buffers (the reference's training
step donates its parameters and state to the jitted step): it writes the
new state and parameters into the old ones with ``update``'s and
``apply_updates``' bits, so that a step holds one copy of them, not two.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.params import leaves, map_tree

__all__ = ["Optimizer", "global_norm_clip", "clip_scale", "apply_updates",
           "add_update", "chunks"]

# elements per piece of a leaf that ``update_`` updates at a time: its
# float32 temporaries stay at 256 MiB each, whatever the leaf's size
CHUNK_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init(params) -> state;  update(grads, state, params, step) ->
    (updates, new_state, metrics).  Updates are *deltas* added to params;
    ``step`` is a Python int.  ``update_(grads, state, params, step) ->
    metrics``, where given, writes ``update``'s new state into ``state``'s
    tensors and ``apply_updates``' result into ``params``' tensors, bit
    for bit."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, int], tuple[Any, Any, dict]]
    update_: Callable[[Any, Any, Any, int], dict] | None = None


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


def add_update(p: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """p + u, added in float32 and stored in p's dtype."""
    return (p.to(torch.float32) + u.to(torch.float32)).to(p.dtype)


def apply_updates(params: Any, updates: Any) -> Any:
    """params + updates, added in float32 and stored in each param's dtype."""
    return map_tree(add_update, params, updates)


def chunks(*ts: torch.Tensor) -> list[tuple[torch.Tensor, ...]]:
    """Same-sized tensors as matching pieces: views of their elements in
    pieces of at most ``CHUNK_ELEMENTS``, in order, where all are plain
    contiguous tensors; otherwise (a DTensor shard, a strided gradient)
    each whole.  An elementwise update of the pieces gives each element
    the bits it gets from the update of the whole."""
    n = ts[0].numel()
    if n <= CHUNK_ELEMENTS or any(type(t) is not torch.Tensor
                                  or not t.is_contiguous() or t.numel() != n
                                  for t in ts):
        return [ts]
    return list(zip(*(t.view(-1).split(CHUNK_ELEMENTS) for t in ts)))
