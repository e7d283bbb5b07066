"""Shared kernel utilities and the Hopper (H100) geometry the kernels target.

The JAX reference describes its Pallas kernels by the TPU's MXU/LANE/SUBLANE
geometry.  The port's kernels are CUDA C++ for ``sm_90a``; what shapes them
is a warp of 32 threads, at most 227 KB of shared memory per block, 132
streaming multiprocessors to fill, and 16-byte loads per thread.
``pick_block`` is kept exactly as the reference has it so that
``repro_torch.runtime.tiling.choose_blocks`` resolves the same block plan.
"""

from __future__ import annotations

__all__ = ["WARP", "SM_COUNT", "SMEM_PER_BLOCK", "VECTOR_BYTES",
           "pick_block"]

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
