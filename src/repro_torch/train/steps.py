"""Training step construction: grads, microbatch accumulation, optimizer.

``make_train_step`` returns a function
    (params, opt_state, batch, step) -> (params, opt_state, metrics)
that is pure in the reference's sense: it returns new trees and updates
nothing in place.  Gradients come from ``torch.autograd.grad`` on a
detached copy of the parameter leaves (no ``.grad`` state survives a
step).  Gradient accumulation loops over microbatches with fp32
accumulators, bounding the activation peak at 1/accum_steps of the global
batch, as the reference's scan does.

Under a mesh (``distributed.compat.enter_mesh``) the trees may hold
DTensors, laid out by ``param_pspecs``, ``opt_pspecs`` and
``batch_pspecs``: the step runs under ``distributed.sharding.mesh_ops``,
each gradient is brought to its parameter's placements (the sum over the
data axes), so that the new parameters keep their layout, and the
metrics come back as whole tensors.  A microbatch whose rows the data
devices do not divide runs padded (``sharding.split_rows``), as XLA pads
the reference's; its pads reach no sum (labels -1, and
``sharding.real_rows`` masks them out of the MoE load-balance loss), and
nothing of them leaves the step.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (like_param, mesh_ops,
                                              real_rows, split_rows)
from repro_torch.models.model import LM
from repro_torch.models.params import leaves, map_tree
from repro_torch.optim.base import Optimizer, apply_updates

__all__ = ["make_train_step", "make_eval_step", "loss_and_grads"]


def _split_microbatches(batch: dict, accum: int) -> list[dict]:
    """The batch's ``accum`` microbatches (``sharding.split_rows``): on a
    mesh whose data devices do not divide a microbatch's rows, each runs
    padded, its pad rows zeros with labels -1, which add nothing to the
    loss's sums."""
    for name, x in batch.items():
        if x.shape[0] % accum:
            raise ValueError(f"batch {name!r} of {x.shape[0]} rows does not "
                             f"split into {accum} microbatches")
    split = {name: split_rows(x, accum, -1 if name == "labels" else 0)
             for name, x in batch.items()}
    return [{name: xs[i] for name, xs in split.items()}
            for i in range(accum)]


def _set_path(tree: dict, path: tuple[str, ...], value: Any) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def loss_and_grads(model: LM, params: dict, batch: dict, *,
                   remat: bool = True) -> tuple[torch.Tensor, dict, dict]:
    """(loss, metrics, grads) of ``model.loss`` at ``params``; grads has
    params' tree and each leaf's dtype (zeros for a leaf the loss does not
    reach, as ``jax.grad`` gives)."""
    with torch.enable_grad():
        live = map_tree(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = model.loss(live, batch, remat=remat)
        flat = list(leaves(live))
        got = torch.autograd.grad(loss, [p for _, p in flat],
                                  allow_unused=True)
    grads: dict = {}
    for (path, p), g in zip(flat, got):
        _set_path(grads, path,
                  torch.zeros_like(p) if g is None else like_param(g, p))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def _whole(metrics: dict) -> dict:
    """Metrics as whole tensors: a DTensor metric (a partial sum over the
    data axes, or a replicated value) gathered; the others as they are."""
    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in metrics.items()}


def make_train_step(model: LM, optimizer: Optimizer, *, accum_steps: int = 1,
                    remat: bool = True, donate: bool = False) -> Callable:
    """With ``donate`` the step takes over ``params`` and ``opt_state``, as
    the reference's jitted step takes its donated buffers: it writes the
    new ones into them (``optimizer.update_``, the same bits) and returns
    them, so that a step holds one copy of the parameters and the state,
    not two.  The caller must not read the old values after the call."""
    if donate and optimizer.update_ is None:
        raise ValueError("this optimizer has no donated update (update_)")

    def train_step(params, opt_state, batch, step: int):
        with mesh_ops():
            return _train_step(params, opt_state, batch, step)

    def _train_step(params, opt_state, batch, step: int):
        if accum_steps == 1:
            loss, metrics, grads = loss_and_grads(model, params, batch,
                                                  remat=remat)
        else:
            gsum = map_tree(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = None
            rows = next(iter(batch.values())).shape[0] // accum_steps
            for mb in _split_microbatches(batch, accum_steps):
                with real_rows(next(iter(mb.values())), rows):
                    l, _, g = loss_and_grads(model, params, mb, remat=remat)
                gsum = map_tree(lambda a, b: a + b.to(torch.float32), gsum, g)
                lsum = l if lsum is None else lsum + l
            grads = map_tree(lambda g: g / accum_steps, gsum)
            loss = lsum / accum_steps
            metrics = {}
        if donate:
            opt_metrics = optimizer.update_(grads, opt_state, params, step)
            new_params, new_opt = params, opt_state
        else:
            updates, new_opt, opt_metrics = optimizer.update(
                grads, opt_state, params, step)
            del grads       # not needed beside the new parameters
            new_params = apply_updates(params, updates)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return new_params, new_opt, _whole(metrics)

    return train_step


def make_eval_step(model: LM, *, remat: bool = False) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad(), mesh_ops():
            loss, metrics = model.loss(params, batch, remat=remat)
            return _whole({"loss": loss, **metrics})
    return eval_step
