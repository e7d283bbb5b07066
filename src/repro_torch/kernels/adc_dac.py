"""Fused converter-boundary emulation on Hopper: DAC -> noise -> ADC.

Emulating the digital/analog boundary inside a model (quantization-aware
training, hardware-in-the-loop studies) is three pointwise passes if
written naively: quantize, add noise, re-quantize, each a full round trip
through device memory.  The kernel fuses them into one pass, together with
the global max that the ADC auto-ranges on; it is hand-written CUDA for
``sm_90a`` (``repro_torch/csrc/adc_dac.cu``, built by
:mod:`repro_torch.kernels.build` and called through ``ctypes``).  It
replaces the Pallas TPU kernel ``_kernel`` of
``src/repro/kernels/adc_dac.py`` and the ``jnp.max`` its wrapper takes
first.

Two routes, chosen by :func:`route` from the element count, the dtype and
the card's SM count and shared memory alone, never by a failure:
``"resident"`` (x fits in the SMs' shared memory: one cooperative launch
that holds x on chip across a grid barrier, so x, noise and out each cross
device memory once) and ``"streamed"`` (larger x: a max kernel, then the
elementwise kernel; x is read twice).  A failed launch raises.

Beside the kernel sits its plain PyTorch version,
:func:`converter_boundary_plain`, the same arithmetic in the same order;
the kernel is bit-equal to it (NaN where it has NaN).  The wrapper takes
it only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  It counts its calls that launched in
``converter_boundary.launches`` and again per route in
``converter_boundary.launches_by_route``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import charged

__all__ = ["converter_boundary", "converter_boundary_plain",
           "reset_launches", "route", "ROUTES"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("resident", "streamed")
_ROUTE_CODE = {"resident": 0, "streamed": 1}
# csrc/adc_dac.cu: a resident chunk is a multiple of 8 elements; of the
# shared-memory opt-in, 1 KB is left to the kernel's static shared memory
# and 16 KB to its table of DAC codes (SMEM_RESERVED); the
# streamed route runs at most 4 CTAs an SM, one partial max each
_CHUNK_ALIGN = 8
_SMEM_RESERVED = 1024 + 16384
_PARTIALS_PER_SM = 4


def route(numel: int, dtype: torch.dtype, sm_count: int,
          smem_per_block: int) -> str:
    """``"resident"`` when x's share of one CTA per SM (``ceil(numel /
    sm_count)`` elements, rounded up to 8) fits in ``smem_per_block``
    bytes less the kernel's own 17 KB (1 KB of static shared memory and
    a 16 KB table), ``"streamed"`` otherwise."""
    chunk = -(-numel // sm_count)
    chunk = -(-chunk // _CHUNK_ALIGN) * _CHUNK_ALIGN
    fits = chunk * dtype.itemsize <= smem_per_block - _SMEM_RESERVED
    return "resident" if fits else "streamed"


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
    ll, f = ctypes.c_longlong, ctypes.c_float
    lib.converter_boundary_forward.argtypes = [
        p, p, p, p, ll, i, i, ll, i, i, f, f, i, p]
    lib.converter_boundary_forward.restype = i
    lib.converter_boundary_limits.argtypes = [ctypes.POINTER(i)] * 2
    lib.converter_boundary_limits.restype = i
    lib.converter_boundary_error_string.argtypes = [i]
    lib.converter_boundary_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _limits(device: torch.device) -> tuple[int, int]:
    """The card's SM count and the shared memory a block may opt in to."""
    lib = _lib()
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        _raise_on(lib, lib.converter_boundary_limits(ctypes.byref(sms),
                                                     ctypes.byref(smem)))
    return sms.value, smem.value


@functools.cache
def _scale_floor(dtype: torch.dtype) -> float:
    """1e-20 as the plain version's ``clamp_min`` rounds it to x's dtype."""
    return torch.clamp_min(torch.tensor(-1.0, dtype=dtype), 1e-20).item()


def _raise_on(lib: ctypes.CDLL, code: int) -> None:
    if code != 0:
        msg = lib.converter_boundary_error_string(code).decode()
        raise RuntimeError(f"converter_boundary: CUDA error {code}: {msg}")


def _launch(x: torch.Tensor, noise: torch.Tensor | None, out: torch.Tensor,
            path: str, dac_bits: int, adc_bits: int,
            noise_std: float) -> None:
    """One call of the C entry point on ``path``'s route, uncounted: x,
    noise and out contiguous on one card, x not empty."""
    sm_count, _ = _limits(x.device)
    partials = torch.empty(_PARTIALS_PER_SM * sm_count, dtype=torch.float32,
                           device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):   # the C entry launches on it
        code = lib.converter_boundary_forward(
            x.data_ptr(), None if noise is None else noise.data_ptr(),
            out.data_ptr(), partials.data_ptr(), partials.numel(),
            _DTYPE_CODE[x.dtype],
            0 if noise is None else _DTYPE_CODE[noise.dtype], x.numel(),
            dac_bits, adc_bits, noise_std, _scale_floor(x.dtype),
            _ROUTE_CODE[path], stream)
    _raise_on(lib, code)


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


@charged()
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

    Any 2-D shape works on either route, and the kernel takes no block
    sizes (the reference's ``block_rows``).  On the card, one call is one
    kernel launch on the ``"resident"`` route and two on ``"streamed"``,
    with no PyTorch reduction around them.
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
    sm_count, smem = _limits(x.device)
    path = route(x.numel(), x.dtype, sm_count, smem)
    _launch(x, noise, out, path, dac_bits, adc_bits, noise_std)
    converter_boundary.launches += 1
    converter_boundary.launches_by_route[path] += 1
    return out


def reset_launches() -> None:
    """Set the kernel's launch counters, in all and per route, to 0."""
    converter_boundary.launches = 0
    converter_boundary.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launches()
