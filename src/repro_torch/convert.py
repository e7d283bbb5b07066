"""Carry state across from the JAX reference into the port.

This system has no model weights: its state is the accelerator spec and
the data (frames, conv kernels, matmul weights).  Both cross as plain
Python and numpy values, so the port never imports the reference:

  :func:`spec_from_fields`  rebuilds the port's ``ConverterSpec``,
                            ``OpticalFourierAcceleratorSpec`` or
                            ``OpticalMVMAcceleratorSpec`` from
                            ``dataclasses.asdict`` of the reference's spec
                            (nested converters included).
  :func:`tensor_from_numpy` hands an array over as a tensor on a device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.core.accelerator import (OpticalFourierAcceleratorSpec,
                                          OpticalMVMAcceleratorSpec)
from repro_torch.core.conversion import ConverterSpec

__all__ = ["spec_from_fields", "tensor_from_numpy"]

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
