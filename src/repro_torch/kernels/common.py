"""Shared kernel utilities and the Hopper (H100) geometry the kernels target.

The JAX reference describes its Pallas kernels by the TPU's MXU/LANE/SUBLANE
geometry.  The port's kernels are CUDA C++ for ``sm_90a``; what shapes them
is a warp of 32 threads, at most 227 KB of shared memory per block, 132
streaming multiprocessors to fill, and 16-byte loads per thread.
``pick_block`` is kept exactly as the reference has it so that
``repro_torch.runtime.tiling.choose_blocks`` resolves the same block plan.
``charged`` lets a FLOP count see the kernels.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

__all__ = ["WARP", "SM_COUNT", "SMEM_PER_BLOCK", "VECTOR_BYTES",
           "pick_block", "charged", "counting"]

# H100 SXM (NVIDIA data sheet): a warp is 32 threads; a block may use
# 232,448 bytes of dynamic shared memory; 132 SMs; 16-byte vector loads.
WARP = 32
SM_COUNT = 132
SMEM_PER_BLOCK = 232_448
VECTOR_BYTES = 16


def pick_block(dim: int, preferred: int, align: int) -> int:
    """Largest block <= preferred that divides ``dim``; falls back to dim.

    Keeps alignment when the dimension allows it — callers pad inputs to
    ``align`` multiples before invoking kernels, so the fallback only fires
    for deliberately tiny test shapes.
    """
    if dim >= preferred and dim % preferred == 0:
        return preferred
    b = min(dim, preferred)
    while b > align and dim % b != 0:
        b -= align
    return b if dim % b == 0 else dim


def _counting_mode():
    """The active counting mode (``core.profiler``'s FLOP count), or None.
    With no dispatch mode active this is one C call."""
    if torch._C._len_torch_dispatch_stack():
        for mode in _get_current_dispatch_mode_stack():
            if hasattr(mode, "charge_kernel"):
                return mode
    return None


def counting() -> bool:
    """True under a counting mode (``core.profiler``'s FLOP count)."""
    return _counting_mode() is not None


def charged(work: Callable[..., dict[str, float]] | None = None):
    """Decorate a kernel wrapper so that ``core.profiler``'s FLOP count
    sees it.

    A launch through ``ctypes`` dispatches no aten op, so a dispatch mode
    counts nothing for it on the card, while on the CPU it would count
    the plain version's ops.  Under a counting mode the decorated call
    charges ``work(*args, **kwargs)`` (FLOPs by category, none when
    ``work`` is None) once, plus what the mode adds for any kernel call,
    and counts nothing inside its body, on every device.  With no
    dispatch mode active the check is one C call.
    """
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            mode = _counting_mode()
            if mode is not None:
                return mode.charge_kernel(
                    work(*args, **kwargs) if work else {}, fn,
                    *args, **kwargs)
            return fn(*args, **kwargs)
        return call
    return wrap
