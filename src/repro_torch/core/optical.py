"""Differentiable 4f optical Fourier/convolution accelerator simulator.

Physics pipeline (paper Fig. 5/7, Appendix A.1), end to end in PyTorch:

  digital input -> DAC quantization -> SLM encoding (amplitude or phase,
  optional macro-pixel aggregation and nearest-neighbour crosstalk)
  -> Fraunhofer propagation (unitary 2-D DFT; the lens does this "for free")
  -> [optional Fourier-plane mask for convolution]
  -> photodetector |field|^2 with shot + read noise
  -> ADC quantization -> digital output.

The camera is square-law: a single capture yields only the *magnitude* of
the Fourier transform (paper App. A.1).  ``phase_captures=4`` enables
four-step phase-shifting interferometry (Macfaden et al.), recovering the
complex field at 4x the read-out/conversion cost — the cost model in
``repro_torch.core.accelerator`` charges for every capture.

Quantizers use a straight-through estimator
(``x + (round(x) - x).detach()``) so the whole accelerator is
differentiable under autograd.  Noise draws come from an explicit
``torch.Generator``; with ``generator=None`` the pipeline is noise-free.
Every function works on whatever device its input lies on.

This module is the *functional* model; the *cost* model lives in
``repro_torch.core.accelerator``.  The hand-written CUDA kernels for the
fused DFT-as-matmul + detector hot path are in
``repro_torch.kernels.optical_dft``; the FFTs here are library FFTs
(``torch.fft.fft2(..., norm="ortho")``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

__all__ = [
    "OpticalSimParams",
    "IDEAL_SIM",
    "dac_quantize",
    "adc_quantize",
    "adc_quantize_batched",
    "macro_pixel_aggregate",
    "slm_crosstalk",
    "fraunhofer",
    "detector_intensity",
    "optical_fft2_magnitude",
    "optical_fft2_complex",
    "optical_conv2d",
    "optical_conv2d_batched",
    "fourier_mask_for_kernel",
]


@dataclasses.dataclass(frozen=True)
class OpticalSimParams:
    """Physics-fidelity knobs for the simulator.

    Attributes:
      dac_bits / adc_bits: converter resolutions on the write/read paths.
      macro_pixel: aggregate k x k SLM pixels into one logical pixel
        (crosstalk mitigation per Anderson et al.; costs k^2 resolution).
      crosstalk: nearest-neighbour SLM coupling coefficient (0 disables).
      shot_noise: photon shot-noise scale (std = sqrt(I * shot_noise)).
      read_noise: additive detector read noise std (in intensity units).
      reference_amplitude: reference-beam amplitude for phase-shifting
        interferometry (complex recovery).
      encoding: how digital values drive the SLM. ``amplitude`` modulates
        field magnitude in [0,1]; ``phase`` maps [0,1] -> [0, 2pi) phase.
    """

    dac_bits: int = 8
    adc_bits: int = 8
    macro_pixel: int = 1
    crosstalk: float = 0.0
    shot_noise: float = 0.0
    read_noise: float = 0.0
    reference_amplitude: float = 1.0
    encoding: Literal["amplitude", "phase"] = "amplitude"

    def __post_init__(self) -> None:
        if self.dac_bits < 1 or self.adc_bits < 1:
            raise ValueError("converter resolutions must be >= 1 bit")
        if self.macro_pixel < 1:
            raise ValueError("macro_pixel must be >= 1")
        if not 0.0 <= self.crosstalk < 0.25:
            raise ValueError("crosstalk must be in [0, 0.25)")


IDEAL_SIM = OpticalSimParams(dac_bits=16, adc_bits=16)


# --- Converter models --------------------------------------------------------

def _maximum(x: torch.Tensor, floor: float) -> torch.Tensor:
    """max(x, floor) splitting the gradient at a tie, as ``jnp.maximum``
    does (``torch.clamp`` would pass all of it)."""
    return torch.maximum(x, x.new_tensor(floor))


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``'s min-of-max, gradient ties included."""
    return torch.minimum(_maximum(x, lo), x.new_tensor(hi))


def _ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() (half to even) with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def dac_quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Uniform quantization of values in [0, 1] to ``bits`` resolution."""
    levels = (1 << bits) - 1
    x = _clip(x, 0.0, 1.0)
    return _ste_round(x * levels) / levels


def adc_quantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """ADC model: auto-ranged uniform quantization of a non-negative signal.

    Real detectors auto-expose; we normalize by the (detached) max so the
    quantizer always uses its full range, then restore scale.
    """
    levels = (1 << bits) - 1
    scale = _maximum(torch.amax(x), 1e-20).detach()
    y = _clip(x / scale, 0.0, 1.0)
    return _ste_round(y * levels) / levels * scale


def adc_quantize_batched(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-frame auto-ranged ADC over a leading batch axis.

    ``x`` is (batch, ...); each frame gets its *own* full-scale setting (a
    camera re-auto-exposes per capture, and frames packed into one batched
    invocation are still read out as independent exposures), so the result
    matches a Python loop of :func:`adc_quantize` over frames exactly.
    """
    levels = (1 << bits) - 1
    dims = tuple(range(1, x.ndim))
    scale = _maximum(torch.amax(x, dim=dims, keepdim=True), 1e-20).detach()
    y = _clip(x / scale, 0.0, 1.0)
    return _ste_round(y * levels) / levels * scale


# --- SLM models ---------------------------------------------------------------

def macro_pixel_aggregate(x: torch.Tensor, k: int) -> torch.Tensor:
    """Mean-pool k x k blocks (Anderson et al. 3x3 macro pixels).

    Output is (H//k, W//k): the accelerator genuinely loses resolution.
    """
    if k == 1:
        return x
    h, w = x.shape[-2], x.shape[-1]
    hk, wk = (h // k) * k, (w // k) * k
    x = x[..., :hk, :wk]
    x = x.reshape(*x.shape[:-2], hk // k, k, wk // k, k)
    return x.mean(dim=(-3, -1))


def slm_crosstalk(x: torch.Tensor, c: float) -> torch.Tensor:
    """Nearest-neighbour pixel coupling: x <- (1-4c) x + c * (4-neighbours)."""
    if c == 0.0:
        return x
    up = torch.roll(x, 1, dims=-2)
    down = torch.roll(x, -1, dims=-2)
    left = torch.roll(x, 1, dims=-1)
    right = torch.roll(x, -1, dims=-1)
    return (1.0 - 4.0 * c) * x + c * (up + down + left + right)


def _slm_field(values: torch.Tensor, params: OpticalSimParams) -> torch.Tensor:
    """Digital values in [0,1] -> complex optical field at the aperture."""
    v = dac_quantize(values, params.dac_bits)
    v = slm_crosstalk(v, params.crosstalk)
    v = macro_pixel_aggregate(v, params.macro_pixel)
    if params.encoding == "amplitude":
        return v.to(torch.complex64)
    phase = (2.0 * math.pi) * v.to(torch.float32)
    return torch.polar(torch.ones_like(phase), phase)


# --- Propagation and detection ------------------------------------------------

def fraunhofer(field: torch.Tensor) -> torch.Tensor:
    """Far-field (Fraunhofer) propagation == unitary 2-D DFT.

    Valid when D >> a and D >> a^2 / lambda (paper App. A.1); the lens in the
    4f system realizes this at distance f.
    """
    return torch.fft.fft2(field, norm="ortho")


def _raw_intensity(field: torch.Tensor, params: OpticalSimParams,
                   generator: torch.Generator | None) -> torch.Tensor:
    """Square-law detection with shot + read noise (pre-ADC)."""
    intensity = field.abs() ** 2
    if generator is not None and (params.shot_noise > 0.0
                                  or params.read_noise > 0.0):
        def normal() -> torch.Tensor:
            return torch.randn(intensity.shape, generator=generator,
                               dtype=intensity.dtype,
                               device=intensity.device)
        std = torch.sqrt(intensity * params.shot_noise)
        intensity = intensity + std * normal()
        intensity = intensity + params.read_noise * normal()
        intensity = _maximum(intensity, 0.0)
    return intensity


def detector_intensity(field: torch.Tensor, params: OpticalSimParams,
                       generator: torch.Generator | None) -> torch.Tensor:
    """Square-law detector with shot + read noise, then ADC quantization."""
    return adc_quantize(_raw_intensity(field, params, generator),
                        params.adc_bits)


def _phase_shift_captures(out: torch.Tensor, params: OpticalSimParams,
                          generator: torch.Generator | None) -> torch.Tensor:
    """Four-step interferometric capture -> recovered complex field.

    All four exposures of a frame share one ADC full-scale setting (a real
    camera does not re-auto-expose between the phase steps; per-capture
    auto-ranging would destroy the linear combination below).  ``out`` may
    carry leading batch axes: each frame then keeps its own full scale.
    """
    r = params.reference_amplitude
    raw = []
    for theta in (0.0, 0.5 * math.pi, math.pi, 1.5 * math.pi):
        ref = r * torch.exp(1j * torch.tensor(theta, dtype=torch.complex64))
        raw.append(_raw_intensity(out + ref.to(out.device), params,
                                  generator))
    stack = torch.stack(raw)                     # (4, ..., H, W)
    levels = (1 << params.adc_bits) - 1
    scale = _maximum(torch.amax(stack, dim=(0, -2, -1), keepdim=True),
                     1e-20).detach()
    y = _clip(stack / scale, 0.0, 1.0)
    i0, i90, i180, i270 = _ste_round(y * levels) / levels * scale
    return torch.complex(i0 - i180, i90 - i270) / (4.0 * r)


# --- Public accelerator ops ----------------------------------------------------

def optical_fft2_magnitude(values: torch.Tensor,
                           params: OpticalSimParams = IDEAL_SIM,
                           generator: torch.Generator | None = None,
                           ) -> torch.Tensor:
    """Single-capture accelerator output: |F(values)| (magnitude only).

    ``values`` must be in [0,1] (host is responsible for range mapping; the
    DAC has a fixed full-scale range).
    """
    field = _slm_field(values, params)
    out = fraunhofer(field)
    # the epsilon keeps d/dI sqrt(I) finite at dark pixels (I == 0)
    return torch.sqrt(_maximum(detector_intensity(out, params, generator),
                               1e-20))


def optical_fft2_complex(values: torch.Tensor,
                         params: OpticalSimParams = IDEAL_SIM,
                         generator: torch.Generator | None = None,
                         ) -> torch.Tensor:
    """Four-step phase-shifting capture: recovers the complex F(values).

    I_theta = |F + r e^{i theta}|^2 for theta in {0, pi/2, pi, 3pi/2};
    F = ((I_0 - I_pi) + i (I_{pi/2} - I_{3pi/2})) / (4 r).
    Costs 4 exposures + 4 ADC passes (see accelerator cost model).
    """
    field = _slm_field(values, params)
    return _phase_shift_captures(fraunhofer(field), params, generator)


def fourier_mask_for_kernel(kernel: torch.Tensor,
                            shape: tuple[int, int] | None = None,
                            params: OpticalSimParams = IDEAL_SIM,
                            ) -> torch.Tensor:
    """Precompute the Fourier-plane mask F(kernel) for a conv kernel.

    In the 4f accelerator the second aperture holds this mask; for repeated
    convolutions with the same kernel (CNNs) its cost is amortized, which is
    why the paper treats kernel upload as negligible next to per-image I/O.
    """
    del params  # the mask is fabricated/programmed at full precision
    if shape is not None:
        h, w = shape
        kernel = torch.nn.functional.pad(
            kernel, (0, w - kernel.shape[-1], 0, h - kernel.shape[-2]))
    return torch.fft.fft2(kernel, norm="ortho")


def optical_conv2d(values: torch.Tensor, fourier_mask: torch.Tensor,
                   params: OpticalSimParams = IDEAL_SIM,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """Circular 2-D convolution via the 4f system (paper Eq. 1).

    The optics compute C = F(A) * mask at the camera plane; the *host*
    performs the final inverse transform digitally (paper App. A.1: "the
    optical setup cannot perform the final inverse Fourier transform step").
    Complex capture (4-step) is required for a faithful convolution; the
    cost model charges 4 reads.

    Returns the real part of ifft2(C) scaled back to unnormalized conv units.
    """
    field = _slm_field(values, params)
    c = fraunhofer(field) * fourier_mask
    c_rec = _phase_shift_captures(c, params, generator)
    # Host-side digital inverse transform (unitary), undoing the two
    # unitary forward transforms' normalization: a true circular conv is
    # ifft2(fft2(a) * fft2(k)) with no norm, = sqrt(HW) * unitary pipeline.
    h, w = c_rec.shape[-2], c_rec.shape[-1]
    scale = math.sqrt(float(h * w))
    return torch.fft.ifft2(c_rec, norm="ortho").real * scale


def optical_conv2d_batched(values: torch.Tensor, fourier_mask: torch.Tensor,
                           params: OpticalSimParams = IDEAL_SIM,
                           generator: torch.Generator | None = None,
                           ) -> torch.Tensor:
    """Batched 4f convolution: ``values`` is (batch, H, W), ONE dispatch.

    Every per-frame reduction — the interferometric captures' shared ADC
    full-scale, the detector auto-range — stays scoped to its own frame
    (:func:`_phase_shift_captures` reduces per leading index), so results
    match a Python loop of single-frame calls while the host pays one
    dispatch for the whole batch.
    """
    if values.ndim != 3:
        raise ValueError(f"expected (batch, H, W), got {tuple(values.shape)}")
    return optical_conv2d(values, fourier_mask, params, generator)
