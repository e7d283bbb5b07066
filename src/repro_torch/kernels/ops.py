"""Public wrappers over the port's hand-written kernels.

Call sites import from here; the kernels and their build stay private.
Each wrapper runs its CUDA kernel for tensors on the card and its plain
PyTorch version for tensors on the CPU.  The reference's other Pallas
kernels (``converter_boundary``, ``local_flash_attention`` and the
``gqa_flash_attention`` wrapper) are not ported yet.
"""

from __future__ import annotations

from repro_torch.kernels.optical_dft import (
    dft_matrix_factors,
    dft_stage1,
    dft_stage1_batched,
    dft_stage2,
    dft_stage2_batched,
    optical_dft2_intensity,
    optical_dft2_intensity_batched,
)

__all__ = [
    "optical_dft2_intensity",
    "optical_dft2_intensity_batched",
    "dft_stage1",
    "dft_stage1_batched",
    "dft_stage2",
    "dft_stage2_batched",
    "dft_matrix_factors",
]
