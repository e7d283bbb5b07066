"""Partition-spec trees for everything that is not a parameter: batches,
decode caches and optimizer states.

The twin of ``repro.distributed.specs``, as plain data: a spec is a tuple
of one entry per dim, each an axis name, a tuple of axis names or None,
keyed on the same leaf names and on the ``stack`` level as the
reference's ``PartitionSpec`` trees.  ``distributed.sharding`` maps them
onto a mesh; the dry run reads them for the per-device bytes.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import map_tree

__all__ = ["batch_pspecs", "cache_pspecs", "opt_pspecs", "DP"]

DP = ("pod", "data")  # logical data-parallel axes (filtered per mesh)


def _dp(mesh_axes: tuple[str, ...]):
    """The data axes the mesh has: a tuple of names, one name alone as
    itself (as ``PartitionSpec`` normalizes it), or None."""
    got = tuple(a for a in DP if a in mesh_axes)
    return (got[0] if len(got) == 1 else got) if got else None


def batch_pspecs(batch_like: Any, mesh_axes: tuple[str, ...],
                 dp_total: int = 32) -> Any:
    """Dim 0 (the global batch) over the data axes, the rest replicated.
    A leaf whose batch dim the dp extent does not divide (long_500k: B=1)
    stays replicated."""
    dp = _dp(mesh_axes)

    def one(x: torch.Tensor) -> tuple:
        lead = dp if (dp is not None and x.shape
                      and x.shape[0] % dp_total == 0) else None
        return (lead,) + (None,) * (len(x.shape) - 1)
    return map_tree(one, batch_like)


def _shard_last(dim: int, tp: int):
    return "model" if dim % tp == 0 else None


def cache_pspecs(cfg: ModelConfig, cache_like: Any,
                 mesh_axes: tuple[str, ...], tp: int, batch: int) -> Any:
    """Decode-cache specs, keyed on leaf names and shapes.

    GQA k/v (B, Hkv, S, hd): batch over the data axes; heads over
    ``model`` when divisible, else the head dim.  The MLA latent
    (B, S, D_lat): D_lat over ``model``.  Recurrent states: the width over
    ``model`` when divisible.  A leaf under ``stack`` gets a leading None.
    The batch stays replicated unless it divides 32, the largest dp extent
    deployed (2 pods x 16).
    """
    dp_axes = _dp(mesh_axes)
    dp = dp_axes if (dp_axes is not None and batch % 32 == 0) else None

    def leaf_spec(keys: tuple[str, ...], x: torch.Tensor) -> tuple:
        stacked = "stack" in keys
        shape = tuple(x.shape[1:] if stacked else x.shape)
        name = keys[-1] if keys else ""
        if name in ("k", "v") and len(shape) == 4:
            _, hk, _, hd = shape
            if hk % tp == 0:
                spec = (dp, "model", None, None)
            elif hd % tp == 0:
                spec = (dp, None, None, "model")
            else:
                spec = (dp, None, None, None)
        elif name == "latent" and len(shape) == 3:
            spec = (dp, None, _shard_last(shape[-1], tp))
        elif name in ("slot_pos", "pos"):
            spec = (None,) * len(shape)
        elif name == "enc_out":
            spec = (dp,) + (None,) * (len(shape) - 1)
        elif name == "c" and len(shape) == 4:   # mLSTM matrix memory
            spec = (dp, None, None, None)
        elif len(shape) >= 2:
            spec = (dp,) + (None,) * (len(shape) - 2) + (
                _shard_last(shape[-1], tp),)
        elif len(shape) == 1:
            spec = (dp,) if dp is not None and shape[0] % 32 == 0 \
                else (None,)
        else:
            spec = ()
        return (None,) + spec if stacked else spec

    def walk(node: Any, keys: tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, keys + (k,)) for k, v in node.items()}
        return leaf_spec(keys, node)

    return walk(cache_like, ())


def opt_pspecs(opt_like: Any, params_pspecs: Any) -> Any:
    """Optimizer-state specs from the parameter specs: AdamW's m and v
    mirror the parameter's spec, Adafactor's vr and vc take it minus the
    reduced dim.  Structural: an optimizer leaf lives under its
    parameter's path with one more level ('m', 'v', 'vr' or 'vc')."""
    def build(opt_node: Any, pspec_node: Any) -> Any:
        if isinstance(opt_node, dict):
            out = {}
            for k, v in opt_node.items():
                if k == "vr" and not isinstance(v, dict):
                    out[k] = tuple(pspec_node[:-1])
                elif k == "vc" and not isinstance(v, dict):
                    out[k] = tuple(pspec_node[:-2]) + (pspec_node[-1],)
                elif k in ("m", "v") and not isinstance(v, dict):
                    out[k] = pspec_node
                else:
                    out[k] = build(v, pspec_node[k]
                                   if isinstance(pspec_node, dict)
                                   and k in pspec_node else pspec_node)
            return out
        return pspec_node

    return build(opt_like, params_pspecs)
