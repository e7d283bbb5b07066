"""Minimal Fourier-optics library in PyTorch (LightPipes/Prysm stand-in).

The twin of the reference's ``benchmarks/optics_sim.py``.  Every FFT-based
propagation runs through the ``OpProfiler`` under the "fft" category,
mirroring the paper's methodology of attributing FFT/conv-named library
functions to the accelerator (App. C.1).  All other tensor math lands in
the profiled 'other' residual.

Fields are complex64 (N, N) grids with physical extent ``size_m``, on the
device ``begin`` was given; every element keeps its field's device.
Propagation uses the band-limited angular-spectrum method (two FFTs per
step, like LightPipes' Forvard).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.profiler import OpProfiler

__all__ = ["Field", "begin", "forvard", "lens", "circ_aperture", "circ_screen",
           "rect_slits", "gauss", "axicon", "spiral_phase_plate", "zone_plate",
           "tilt", "intensity", "lenslet_array", "hermite_gauss", "far_field"]


@dataclasses.dataclass
class Field:
    u: torch.Tensor         # complex amplitude (N, N)
    size_m: float           # physical side length
    wavelength: float

    @property
    def n(self) -> int:
        return self.u.shape[0]

    def grid(self) -> tuple[torch.Tensor, torch.Tensor]:
        n = self.n
        x = (torch.arange(n, device=self.u.device) - n / 2) * (self.size_m / n)
        return torch.meshgrid(x, x, indexing="xy")


def begin(size_m: float, wavelength: float, n: int,
          device: str | torch.device = "cuda") -> Field:
    return Field(torch.ones((n, n), dtype=torch.complex64, device=device),
                 size_m, wavelength)


def intensity(f: Field) -> torch.Tensor:
    return f.u.abs() ** 2


# --- elements (pure phase/amplitude masks: 'other' time) -----------------------


def circ_aperture(f: Field, radius: float, x0=0.0, y0=0.0) -> Field:
    x, y = f.grid()
    mask = ((x - x0) ** 2 + (y - y0) ** 2) <= radius ** 2
    return Field(f.u * mask, f.size_m, f.wavelength)


def circ_screen(f: Field, radius: float) -> Field:
    x, y = f.grid()
    mask = (x ** 2 + y ** 2) > radius ** 2
    return Field(f.u * mask, f.size_m, f.wavelength)


def rect_slits(f: Field, width: float, height: float,
               centers: list[tuple[float, float]]) -> Field:
    x, y = f.grid()
    mask = torch.zeros(f.u.shape, dtype=torch.bool, device=f.u.device)
    for (cx, cy) in centers:
        mask |= ((x - cx).abs() <= width / 2) & ((y - cy).abs() <= height / 2)
    return Field(f.u * mask, f.size_m, f.wavelength)


def gauss(f: Field, w0: float) -> Field:
    x, y = f.grid()
    return Field(f.u * torch.exp(-(x ** 2 + y ** 2) / w0 ** 2), f.size_m,
                 f.wavelength)


def lens(f: Field, focal_m: float) -> Field:
    x, y = f.grid()
    k = 2 * math.pi / f.wavelength
    phase = -k * (x ** 2 + y ** 2) / (2 * focal_m)
    return Field(f.u * torch.exp(1j * phase), f.size_m, f.wavelength)


def axicon(f: Field, cone_rad: float) -> Field:
    x, y = f.grid()
    k = 2 * math.pi / f.wavelength
    r = torch.sqrt(x ** 2 + y ** 2)
    return Field(f.u * torch.exp(-1j * k * r * cone_rad), f.size_m,
                 f.wavelength)


def spiral_phase_plate(f: Field, charge: int = 1) -> Field:
    x, y = f.grid()
    return Field(f.u * torch.exp(1j * charge * torch.atan2(y, x)), f.size_m,
                 f.wavelength)


def zone_plate(f: Field, focal_m: float) -> Field:
    x, y = f.grid()
    r2 = x ** 2 + y ** 2
    zones = torch.floor(r2 / (f.wavelength * focal_m)).to(torch.int32)
    return Field(f.u * (zones % 2 == 0), f.size_m, f.wavelength)


def tilt(f: Field, tx: float, ty: float) -> Field:
    x, y = f.grid()
    k = 2 * math.pi / f.wavelength
    return Field(f.u * torch.exp(1j * k * (x * tx + y * ty)), f.size_m,
                 f.wavelength)


def lenslet_array(f: Field, pitch: float, focal_m: float) -> Field:
    x, y = f.grid()
    xl = torch.remainder(x + pitch / 2, pitch) - pitch / 2
    yl = torch.remainder(y + pitch / 2, pitch) - pitch / 2
    k = 2 * math.pi / f.wavelength
    return Field(f.u * torch.exp(-1j * k * (xl ** 2 + yl ** 2) / (2 * focal_m)),
                 f.size_m, f.wavelength)


def hermite_gauss(f: Field, m: int, n: int, w0: float) -> Field:
    """The Hermite polynomials are evaluated on the host in float64
    (numpy), as the reference evaluates them, then sent back to the
    field's device."""
    x, y = f.grid()
    hx = np.polynomial.hermite.hermval(
        (math.sqrt(2) * x / w0).cpu().numpy(), [0] * m + [1])
    hy = np.polynomial.hermite.hermval(
        (math.sqrt(2) * y / w0).cpu().numpy(), [0] * n + [1])
    env = torch.exp(-(x ** 2 + y ** 2) / w0 ** 2)
    h = torch.from_numpy(hx * hy).to(device=f.u.device, dtype=torch.float32)
    return Field(f.u * h * env, f.size_m, f.wavelength)


# --- propagation (the FFT hot path) ----------------------------------------------


def _fftfreq(n: int, d: float, device: torch.device) -> torch.Tensor:
    """The reference's float32 FFT frequencies, bit for bit: k / (d n) by
    true division.  ``torch.fft.fftfreq`` multiplies by 1 / (d n), and a
    CUDA division by a scalar does too; either can move a frequency by one
    ulp."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    k = (i + n // 2) % n - n // 2
    return k / torch.full_like(k, d * n)


def _propagate(u: torch.Tensor, size_m: float, wavelength: float,
               z_m: float) -> torch.Tensor:
    n = u.shape[0]
    fx = _fftfreq(n, size_m / n, u.device)
    fxx, fyy = torch.meshgrid(fx, fx, indexing="xy")
    arg = 1.0 - (wavelength * fxx) ** 2 - (wavelength * fyy) ** 2
    # kz * z reaches ~1e7 rad, where one float32 ulp of kz (or of a
    # frequency) turns the phase by ~0.5 rad.  So the frequencies above
    # are the reference's bits, and this is the correctly rounded float32
    # sqrt (as XLA's and CUDA's are; PyTorch's vectorized CPU sqrt is
    # not), through float64.
    root = torch.sqrt(torch.clamp(arg, min=0.0).double()).float()
    kz = 2 * math.pi / wavelength * root
    h = torch.exp(1j * kz * z_m) * (arg > 0)
    return torch.fft.ifft2(torch.fft.fft2(u) * h)


def forvard(f: Field, z_m: float, prof: OpProfiler | None = None) -> Field:
    """Angular-spectrum propagation over distance z (2 FFTs)."""
    if prof is not None:
        u = prof.run("fft", _propagate, f.u, f.size_m, f.wavelength, z_m)
    else:
        u = _propagate(f.u, f.size_m, f.wavelength, z_m)
    return Field(u, f.size_m, f.wavelength)


def _far_field(u: torch.Tensor) -> torch.Tensor:
    return torch.fft.fftshift(torch.fft.fft2(u, norm="ortho"))


def far_field(f: Field, prof: OpProfiler | None = None) -> torch.Tensor:
    """Fraunhofer far field (1 FFT), shifted to center."""
    if prof is not None:
        return prof.run("fft", _far_field, f.u)
    return _far_field(f.u)
