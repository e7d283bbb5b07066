"""Plain PyTorch oracles for the port's kernels (the allclose targets).

Each function is the semantic specification of its kernel: the DFT
stages with complex64 products and library FFTs rather than the kernels'
(re, im) planes, the converter boundary as the reference's three passes,
attention as a dense masked softmax with the KV heads repeated; tests
sweep shapes and assert kernel-vs-oracle agreement.
"""

from __future__ import annotations

import torch

__all__ = [
    "optical_dft2_intensity_ref",
    "dft_stage1_ref",
    "dft_stage2_ref",
    "converter_boundary_ref",
    "local_attention_ref",
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


def converter_boundary_ref(x, noise=None, *, dac_bits: int = 8,
                           adc_bits: int = 8, noise_std: float = 0.0):
    """DAC quantize -> + noise_std * noise -> ADC at max(max(x), 1e-20)."""
    y = _quantize(x.to(torch.float32), dac_bits)
    if noise is not None and noise_std > 0.0:
        y = y + noise_std * noise.to(torch.float32)
    scale = torch.clamp_min(torch.max(x), 1e-20).to(torch.float32)
    z = torch.clamp(y / scale, 0.0, 1.0)
    levels = (1 << adc_bits) - 1
    return (torch.round(z * levels) / levels * scale).to(x.dtype)


def local_attention_ref(q, k, v, *, scale=None, window: int = 0,
                        causal: bool = True, kv_groups: int = 1):
    """Dense masked softmax attention, (BH, Lq, D) x (BHkv, Lk, D)."""
    bh, lq, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if kv_groups > 1:
        k = torch.repeat_interleave(k, kv_groups, dim=0)
        v = torch.repeat_interleave(v, kv_groups, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    qi = torch.arange(lq, device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((lq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= (qi - ki) < window
    s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p,
                        v.to(torch.float32)).to(q.dtype)
