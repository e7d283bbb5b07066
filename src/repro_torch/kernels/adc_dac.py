"""Fused converter-boundary emulation on Hopper: DAC -> noise -> ADC.

Emulating the digital/analog boundary inside a model (quantization-aware
training, hardware-in-the-loop studies) is three pointwise passes if
written naively: quantize, add noise, re-quantize, each a full round trip
through device memory.  The kernel fuses them into one pass; it is
hand-written CUDA for ``sm_90a`` (``repro_torch/csrc/adc_dac.cu``, built by
:mod:`repro_torch.kernels.build` and called through ``ctypes``).  It
replaces the Pallas TPU kernel ``_kernel`` of
``src/repro/kernels/adc_dac.py``.

The ADC auto-ranges on the *global* max, which one elementwise pass cannot
see, so the wrapper takes it first with a PyTorch reduction that stays on
the device (no ``.item()``) and hands the kernel a pointer to it, as the
reference's wrapper computes it with ``jnp.max`` outside its kernel.

Beside the kernel sits its plain PyTorch version,
:func:`converter_boundary_plain`, the same arithmetic in the same order.
The wrapper takes it only for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  It counts its launches in
``converter_boundary.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["converter_boundary", "converter_boundary_plain",
           "reset_launches"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(x: torch.Tensor) -> torch.Tensor:
    """The ADC's full scale, max(max(x), 1e-20), as a float32 scalar on x's
    device (the max is taken in x's dtype, as the reference takes it)."""
    return torch.clamp_min(x.amax(), 1e-20).to(torch.float32)


def converter_boundary_plain(x: torch.Tensor,
                             noise: torch.Tensor | None = None, *,
                             dac_bits: int = 8, adc_bits: int = 8,
                             noise_std: float = 0.0) -> torch.Tensor:
    """DAC on [0, 1] -> ``+ noise_std * noise`` -> ADC at the global max, in
    float32, returned in x's dtype.

    The converter levels are 0-d tensors on x's device, not Python floats:
    on a CUDA tensor PyTorch turns a division by a Python scalar into a
    multiplication by its reciprocal, which can differ by one ulp from the
    IEEE divide the reference and the kernel compute, and one ulp can move
    a value across a rounding tie."""
    ld = torch.full((), float((1 << dac_bits) - 1), device=x.device)
    la = torch.full((), float((1 << adc_bits) - 1), device=x.device)
    y = torch.round(torch.clamp(x.to(torch.float32), 0.0, 1.0) * ld) / ld
    if noise is not None and noise_std > 0.0:
        y = y + noise_std * noise.to(torch.float32)
    s = _scale(x)
    z = torch.clamp(y / s, 0.0, 1.0)
    return (torch.round(z * la) / la * s).to(x.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with every argument typed
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    from repro_torch.kernels.build import library
    lib = library("adc_dac")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.converter_boundary_forward.argtypes = [
        p, p, p, p, i, i, ctypes.c_longlong, i, i, ctypes.c_float, p]
    lib.converter_boundary_forward.restype = i
    lib.converter_boundary_error_string.argtypes = [i]
    lib.converter_boundary_error_string.restype = ctypes.c_char_p
    return lib


def _on_cpu(x: torch.Tensor, noise: torch.Tensor | None) -> bool:
    """True when x (and noise) lie on the CPU (take the plain version),
    False when they lie on one CUDA device in a type and layout the kernel
    takes (launch it); raises on anything else."""
    tensors = [x] if noise is None else [x, noise]
    devices = {t.device for t in tensors}
    if all(dv.type == "cpu" for dv in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError("converter_boundary: x and noise must both lie on "
                         "the CPU or on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError("converter_boundary: the CUDA kernel takes x in "
                        f"float32 or bfloat16, got {x.dtype}")
    if noise is not None and noise.dtype not in (torch.float32, x.dtype):
        raise TypeError("converter_boundary: the CUDA kernel takes noise in "
                        f"float32 or x's dtype, got {noise.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("converter_boundary: the CUDA kernel takes "
                         "contiguous operands")
    return False


def converter_boundary(x: torch.Tensor, noise: torch.Tensor | None = None,
                       *, dac_bits: int = 8, adc_bits: int = 8,
                       noise_std: float = 0.0) -> torch.Tensor:
    """Fused DAC -> analog noise -> ADC boundary for a 2-D tensor in [0, 1].

    Args:
      x: (h, w), float32 or bfloat16; the result has its dtype.
      noise: (h, w) pre-drawn unit gaussians in float32 or x's dtype, or
        None; the noise step runs only when it is given and
        ``noise_std > 0``.
      dac_bits, adc_bits: converter resolutions (1..24).

    The kernel is a grid-stride elementwise pass: any 2-D shape works, and
    it takes no block sizes (the reference's ``block_rows``).
    """
    if x.ndim != 2:
        raise ValueError("converter_boundary: expected a 2-D x, got shape "
                         f"{tuple(x.shape)}")
    if noise is not None and noise.shape != x.shape:
        raise ValueError(f"converter_boundary: noise {tuple(noise.shape)} "
                         f"does not match x {tuple(x.shape)}")
    for name, bits in (("dac_bits", dac_bits), ("adc_bits", adc_bits)):
        if not 1 <= bits <= 24:
            raise ValueError(f"converter_boundary: {name} must be in "
                             f"[1, 24], got {bits}")
    if noise_std <= 0.0:
        noise = None
    if _on_cpu(x, noise):
        return converter_boundary_plain(x, noise, dac_bits=dac_bits,
                                        adc_bits=adc_bits,
                                        noise_std=noise_std)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    scale = _scale(x)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):   # the C entry launches on it
        code = lib.converter_boundary_forward(
            x.data_ptr(), None if noise is None else noise.data_ptr(),
            scale.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
            0 if noise is None else _DTYPE_CODE[noise.dtype], x.numel(),
            dac_bits, adc_bits, noise_std, stream)
    if code != 0:
        msg = lib.converter_boundary_error_string(code).decode()
        raise RuntimeError(f"converter_boundary: CUDA error {code}: {msg}")
    converter_boundary.launches += 1
    return out


converter_boundary.launches = 0


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    converter_boundary.launches = 0
