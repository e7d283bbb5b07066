"""Public wrappers over the port's hand-written kernels.

Call sites import from here; the kernels and their build stay private.
Each wrapper runs its CUDA kernel for tensors on the card and its plain
PyTorch version for tensors on the CPU: the DFT stages
(``optical_dft``), the converter boundary (``converter_boundary``) and the
flash attention (``local_flash_attention``, with the 4-D
``gqa_flash_attention`` wrapper), which is differentiable.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.adc_dac import converter_boundary
from repro_torch.kernels.local_attention import local_flash_attention
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
    "converter_boundary",
    "local_flash_attention",
    "gqa_flash_attention",
]


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, causal: bool = True,
                        ) -> torch.Tensor:
    """(B, Hq, L, D) grouped-query flash attention over 4-D operands.

    Flattens (batch, heads) onto the kernel's leading axis; KV heads are
    shared across groups inside the kernel (no repeat).  Operands that are
    not contiguous are made so first.
    """
    b, hq, lq, d = q.shape
    _, hkv, lk, _ = k.shape
    if hq % hkv:
        raise ValueError(f"gqa_flash_attention: {hq} query heads do not "
                         f"group over {hkv} KV heads")
    out = local_flash_attention(
        q.reshape(b * hq, lq, d).contiguous(),
        k.reshape(b * hkv, lk, d).contiguous(),
        v.reshape(b * hkv, lk, d).contiguous(),
        window=window, causal=causal, kv_groups=hq // hkv,
    )
    return out.reshape(b, hq, lq, d)
