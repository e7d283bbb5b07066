"""Plain PyTorch oracles for the DFT kernels (the allclose targets).

Each function is the semantic specification of its kernel, written with
complex64 products and library FFTs rather than the kernels' (re, im)
planes; tests sweep shapes and assert kernel-vs-oracle agreement.
"""

from __future__ import annotations

import torch

__all__ = [
    "optical_dft2_intensity_ref",
    "dft_stage1_ref",
    "dft_stage2_ref",
]


def _quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    levels = (1 << bits) - 1
    return torch.round(torch.clamp(x, 0.0, 1.0) * levels) / levels


def _complex(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.complex(re.to(torch.float32), im.to(torch.float32))


def dft_stage1_ref(wr, wi, a, *, dac_bits: int = 0):
    a = a.to(torch.float32)
    if dac_bits:
        a = _quantize(a, dac_bits)
    t = _complex(wr, wi) @ a.to(torch.complex64)
    return t.real, t.imag


def dft_stage2_ref(tr, ti, wr, wi):
    u = _complex(tr, ti) @ _complex(wr, wi).T
    return u.abs() ** 2


def optical_dft2_intensity_ref(a: torch.Tensor, *,
                               dac_bits: int = 8) -> torch.Tensor:
    """|unitary 2-D DFT of quantize(a)|^2 — matches repro_torch.core.optical."""
    a = a.to(torch.float32)
    if dac_bits:
        a = _quantize(a, dac_bits)
    f = torch.fft.fft2(a.to(torch.complex64), norm="ortho")
    return f.abs() ** 2
