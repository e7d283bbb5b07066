"""Mesh-aware sharding helpers, over DTensor.

The twin of ``repro.distributed.sharding``.  A partition spec is plain
data (``models.params.param_pspecs``, ``distributed.specs``): one entry
per tensor dim, each an axis name, a tuple of axis names or None.
:func:`logical_to_mesh` drops the names the current mesh does not define,
so that the same model code runs on the single-pod ``(data, model)``
mesh, the multi-pod ``(pod, data, model)`` mesh and tiny test meshes;
:func:`placements` maps a spec to DTensor placements on a mesh, and
:func:`distribute_tree` distributes a params, optimizer-state or batch
tree by its spec tree.

:func:`constrain` is the one entry point the model uses to pin an
activation's layout: the identity on a plain tensor or off a mesh, and a
``redistribute`` to the filtered spec for a DTensor under a mesh.
:func:`shard_devices` places the sharded offload backend's work and has
nothing to do with the mesh.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator, Sequence

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

__all__ = ["constrain", "batch_axes", "current_axis_names",
           "logical_to_mesh", "activation_sharding_mode",
           "constrain_residual", "placements", "distribute_tree",
           "like_param", "mesh_ops", "shard_devices"]


def activation_sharding_mode() -> str:
    """'baseline': the layouts follow the parameters only; 'dp': the
    residual stream is pinned batch-sharded at block boundaries; 'sp':
    batch over the data axes and the sequence over ``model``.  Read from
    ``REPRO_ACT_SHARDING``, as the reference reads it."""
    return os.environ.get("REPRO_ACT_SHARDING", "baseline")


def constrain_residual(x: torch.Tensor) -> torch.Tensor:
    """Pin a (B, S, D) residual-stream tensor between blocks, by
    :func:`activation_sharding_mode` ('dp': batch over the data axes;
    'sp': also the sequence over ``model``).  The identity in 'baseline'
    and when the batch does not divide 32 (the largest dp extent, 2 x
    16)."""
    mode = activation_sharding_mode()
    if mode not in ("dp", "sp") or x.shape[0] % 32 != 0:
        return x
    if mode == "sp" and x.ndim == 3 and x.shape[1] % 16 == 0:
        return constrain(x, ("pod", "data"), "model", None)
    return constrain(x, ("pod", "data"), None, None)


def current_axis_names() -> tuple[str, ...]:
    from repro_torch.distributed.compat import current_mesh_axis_names
    return current_mesh_axis_names()


def _filter_spec(spec: Any, axes: tuple[str, ...]) -> Any:
    if spec is None:
        return None
    if isinstance(spec, (tuple, list)):
        kept = tuple(a for a in spec if a in axes)
        return kept if kept else None
    return spec if spec in axes else None


def logical_to_mesh(pspec: Sequence) -> tuple | None:
    """``pspec`` without the axis names the current mesh does not define;
    None off a mesh."""
    axes = current_axis_names()
    if not axes:
        return None
    return tuple(_filter_spec(s, axes) for s in pspec)


def placements(spec: Sequence, mesh) -> list[Placement]:
    """DTensor placements of a tensor laid out by ``spec`` on ``mesh``:
    ``Shard(d)`` on every mesh dim that dim d's entry names (a dim over
    ``(pod, data)`` is sharded over both, pod major, as the reference's
    ``PartitionSpec`` splits it), ``Replicate()`` on a mesh dim no entry
    names.  Names the mesh does not define are ignored."""
    out: list[Placement] = [Replicate()] * mesh.ndim
    names = list(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            if name in names:
                out[names.index(name)] = Shard(d)
    return out


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every tensor of ``tree`` (params, optimizer state or a batch, the
    same on every rank) as a DTensor on ``mesh``, laid out by its leaf of
    ``specs``."""
    from repro_torch.models.params import map_tree   # models import us
    return map_tree(lambda t, s: distribute_tensor(t, mesh,
                                                   placements(s, mesh)),
                    tree, specs)


def like_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A gradient laid out as its parameter: a DTensor gradient (Partial
    over the data axes, where the batch was sharded) is redistributed to
    ``p``'s placements, which sums it over them; a plain one is returned
    as it is."""
    if isinstance(g, DTensor) and isinstance(p, DTensor) \
            and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


@contextlib.contextmanager
def mesh_ops() -> Iterator[None]:
    """Under a current mesh, plain tensors that the model makes for itself
    (RoPE angles, masks, ``arange``s, zeros) join DTensor ops as
    replicated DTensors; they are the same on every rank.  Off a mesh it
    does nothing.  Not reentrant: the train and eval steps enter it once,
    around forward and backward both (a checkpointed block's recompute
    runs in backward)."""
    from repro_torch.distributed.compat import current_mesh
    if current_mesh() is None:
        yield
        return
    with implicit_replication():
        yield


def constrain(x: torch.Tensor, *spec: Any) -> torch.Tensor:
    """Pin ``x``'s layout to ``spec``: the identity on a plain tensor or
    off a mesh; a DTensor under a mesh is redistributed to the spec
    filtered for that mesh (differentiably)."""
    resolved = logical_to_mesh(spec)
    if resolved is None or not isinstance(x, DTensor):
        return x
    want = placements(resolved, x.device_mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def batch_axes() -> tuple[str, ...] | None:
    """Axes the global batch shards over: ("pod", "data") where both
    exist."""
    axes = current_axis_names()
    got = tuple(a for a in ("pod", "data") if a in axes)
    return got if got else None


def shard_devices(n: int, home: torch.device) -> list[torch.device] | None:
    """Pick ``n`` distinct devices to scatter work shards onto.

    When ``home`` (the executor's device) is a CUDA card and the machine
    has at least ``n`` cards, the shards go to ``cuda:0 .. cuda:n-1``.
    Otherwise — one card, or the CPU — this returns None: the caller's cue
    to take the sequential fallback, where the shards dispatch in turn on
    ``home`` with identical numerics (the reference's off-mesh fallback).
    """
    if n <= 1 or home.type != "cuda" or torch.cuda.device_count() < n:
        return None
    return [torch.device("cuda", i) for i in range(n)]
