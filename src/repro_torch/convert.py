"""Carry state across from the JAX reference into the port.

The offload runtime's state is the accelerator spec and the data (frames,
conv kernels, matmul weights); the LM stack's is its parameter tree.  All
of it crosses as plain Python and numpy values, so the port never imports
the reference:

  :func:`spec_from_fields`      rebuilds the port's ``ConverterSpec``,
                                ``OpticalFourierAcceleratorSpec`` or
                                ``OpticalMVMAcceleratorSpec`` from
                                ``dataclasses.asdict`` of the reference's
                                spec (nested converters included).
  :func:`tensor_from_numpy`     hands an array over as a tensor on a device.
  :func:`lm_params_from_numpy`  turns the reference's ``init_params`` tree,
                                given as numpy arrays, into the port's
                                parameters, so both compute the same thing.
  :func:`adamw_state_from_numpy` turns the reference's AdamW state
                                (``{"m", "v"}`` trees of numpy arrays)
                                into the port's, so training resumes
                                where the reference left it.
  :func:`adafactor_state_from_numpy` does the same for the reference's
                                Adafactor state (``{"v": tree of
                                {"vr", "vc"} | {"v"}}``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.accelerator import (OpticalFourierAcceleratorSpec,
                                          OpticalMVMAcceleratorSpec)
from repro_torch.core.conversion import ConverterSpec
from repro_torch.models.config import ModelConfig, torch_dtype
from repro_torch.models.params import ParamSpec, map_tree, model_templates

__all__ = ["spec_from_fields", "tensor_from_numpy", "lm_params_from_numpy",
           "adamw_state_from_numpy", "adafactor_state_from_numpy"]

_SPECS = (ConverterSpec, OpticalFourierAcceleratorSpec,
          OpticalMVMAcceleratorSpec)


def _field_names(cls) -> frozenset[str]:
    return frozenset(f.name for f in dataclasses.fields(cls))


def spec_from_fields(d: Mapping[str, Any]):
    """The port's spec whose fields are exactly ``d``'s keys.

    Nested dicts that are converter fields (``dac``, ``adc``) are rebuilt
    as :class:`ConverterSpec`; lists (a round trip through JSON) become
    tuples.  Raises ``ValueError`` when no spec class has ``d``'s fields.
    """
    keys = frozenset(d)
    cls = next((c for c in _SPECS if _field_names(c) == keys), None)
    if cls is None:
        raise ValueError(f"no spec class has the fields {sorted(keys)}")
    kwargs = {}
    for k, v in d.items():
        if isinstance(v, Mapping):
            v = spec_from_fields(v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def tensor_from_numpy(a, device: str | torch.device = "cuda",
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """``a`` (a numpy array, or anything ``np.asarray`` takes) as a
    contiguous tensor on ``device``, in ``dtype`` when given."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t.to(device=device, dtype=dtype or t.dtype)


def _tensor(a, device, dtype: torch.dtype) -> torch.Tensor:
    a = np.array(a)   # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: reinterpret bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def _from_template(tree: Mapping[str, Any], cfg: ModelConfig, device,
                   dtype_of, template=None) -> dict:
    """``tree`` as tensors on ``device``, checked leaf by leaf against
    ``template`` (the port's parameter templates for ``cfg`` when None);
    ``dtype_of(spec)`` gives each leaf's dtype.  Raises ``ValueError``
    naming the first leaf that differs in keys or shape."""

    def walk(spec_node, node, path):
        if isinstance(spec_node, dict):
            if not isinstance(node, Mapping) or set(node) != set(spec_node):
                got = sorted(node) if isinstance(node, Mapping) else node
                raise ValueError(f"{path or 'params'}: expected keys "
                                 f"{sorted(spec_node)}, got {got}")
            return {k: walk(spec_node[k], node[k], f"{path}/{k}")
                    for k in spec_node}
        shape = tuple(np.shape(node))
        if shape != spec_node.shape:
            raise ValueError(f"{path}: expected shape {spec_node.shape}, "
                             f"got {shape}")
        return _tensor(node, device, dtype_of(spec_node))

    return walk(model_templates(cfg) if template is None else template,
                tree, "")


def lm_params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                         device: str | torch.device = "cuda") -> dict:
    """The port's parameters from the reference's ``init_params`` tree
    (nested dicts of arrays, e.g. ``jax.tree_util.tree_map(np.asarray,
    params)``), on ``device`` in the config's ``param_dtype``.

    The tree must have exactly the port's template keys and shapes for
    ``cfg``; raises ``ValueError`` naming the first leaf that differs.
    """
    dtype = torch_dtype(cfg.param_dtype)
    return _from_template(tree, cfg, device, lambda spec: torch_dtype(
        spec.dtype) if spec.dtype else dtype)


def adamw_state_from_numpy(state: Mapping[str, Any], cfg: ModelConfig,
                           device: str | torch.device = "cuda") -> dict:
    """The port's AdamW state from the reference's ``adamw(...).init`` /
    ``update`` state ``{"m": tree, "v": tree}`` as numpy arrays: float32
    moments on ``device``, each tree checked against the parameter
    templates as :func:`lm_params_from_numpy` checks parameters."""
    if not isinstance(state, Mapping) or set(state) != {"m", "v"}:
        got = sorted(state) if isinstance(state, Mapping) else state
        raise ValueError(f"AdamW state: expected keys ['m', 'v'], got {got}")
    return {k: _from_template(state[k], cfg, device,
                              lambda spec: torch.float32)
            for k in ("m", "v")}


def adafactor_state_from_numpy(state: Mapping[str, Any], cfg: ModelConfig,
                               device: str | torch.device = "cuda", *,
                               min_dim_size_to_factor: int = 128) -> dict:
    """The port's Adafactor state from the reference's ``adafactor(...)``
    ``init`` / ``update`` state ``{"v": tree}`` as numpy arrays: float32
    on ``device``.  Each parameter's entry must be ``{"vr", "vc"}`` (its
    row and column means) where both of its last two dims are at least
    ``min_dim_size_to_factor``, else ``{"v"}`` of its own shape, as the
    optimizer built with the same setting keeps them; raises
    ``ValueError`` naming the first entry that differs."""
    if not isinstance(state, Mapping) or set(state) != {"v"}:
        got = sorted(state) if isinstance(state, Mapping) else state
        raise ValueError(f"Adafactor state: expected keys ['v'], got {got}")
    m = min_dim_size_to_factor

    def entry(spec: ParamSpec) -> dict:
        sh = spec.shape
        if len(sh) >= 2 and sh[-1] >= m and sh[-2] >= m:
            return {"vr": ParamSpec(sh[:-1]),
                    "vc": ParamSpec(sh[:-2] + sh[-1:])}
        return {"v": ParamSpec(sh)}

    template = map_tree(entry, model_templates(cfg))
    return {"v": _from_template(state["v"], cfg, device,
                                lambda spec: torch.float32, template)}
