"""The paper's 27-benchmark Amdahl case study (Table 1 / Figure 9), in PyTorch.

The twin of the reference's ``benchmarks/amdahl_suite.py``: the same 27
applications at the same sizes, each FFT/conv library call bracketed
under the profiler's accelerable categories (App. C.1); the ideal
(zero-cost) optical accelerator's end-to-end speedup is the Amdahl bound
1 / (1 - f_accel).  Each benchmark is warmed up once (cuFFT plans, cuDNN
algorithms, the caching allocator) and timed over REPEATS runs.

Every benchmark takes the device it runs on; ``run_suite`` runs on the
CUDA card unless asked for the CPU.  On the card each bracket waits for
the device on entry and exit (``OpProfiler``), so the fractions are the
card's: a new measurement, not the paper's i7 numbers (carried in
PAPER_TABLE1 for side-by-side comparison) nor the reference's CPU run.
Random inputs come from a ``torch.Generator`` on the device per draw,
seeded with the number of the reference's ``PRNGKey`` (a ``fold_in`` of
key k with data i is seed ``k * 1000 + i``): same key, same tensor, as in
the reference, but not the reference's values.
"""

from __future__ import annotations

import cmath
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.casestudy import optics_sim as op
from repro_torch.core.amdahl import AmdahlReport, report
from repro_torch.core.profiler import OpProfiler

__all__ = ["run_suite", "run_one", "BENCHMARKS", "PAPER_TABLE1", "REPEATS"]

REPEATS = 3
_WL = 633e-9  # HeNe

# (fft/conv %, end-to-end speedup) from the paper's Table 1, same order.
PAPER_TABLE1 = {
    "convolution": (99.37, 159.41),
    "fourier_transform": (97.79, 45.32),
    "wiener_filter": (67.51, 3.08),
    "airy_beam": (63.24, 2.72),
    "youngs_experiment": (61.70, 2.61),
    "poisson_to_bessel": (61.33, 2.59),
    "bessel_annular_slit": (60.82, 2.55),
    "bessel_axicon": (60.71, 2.55),
    "multi_holes_slits": (60.70, 2.55),
    "circular_aperture": (60.65, 2.54),
    "shack_hartmann": (52.88, 2.12),
    "spot_of_poisson": (48.44, 1.94),
    "fresnel_zone_plate": (47.34, 1.90),
    "unstable_resonator": (39.43, 1.65),
    "doughnut_collinear": (30.54, 1.44),
    "michelson": (29.45, 1.42),
    "phase_recovery": (18.75, 1.23),
    "spiral_phase_plate": (18.75, 1.23),
    "hermite_to_laguerre": (18.29, 1.22),
    "doughnut_tilted": (7.31, 1.08),
    "double_slit_prysm": (55.91, 2.27),
    "first_diffraction_model": (47.80, 1.92),
    "image_simulation": (10.95, 1.12),
    "cnn_inference": (63.17, 2.71),
    "cnn_training": (10.68, 1.12),
    "audio_resampling": (37.94, 1.61),
    "wav2vec2_inference": (34.53, 1.53),
}


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _fold_in(seed: int, data: int) -> int:
    return seed * 1000 + data


def _normal(seed: int, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=_gen(seed, device), device=device)


def _uniform(seed: int, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=_gen(seed, device), device=device)


def _ready(x: torch.Tensor) -> None:
    """Wait for ``x``, as the reference's ``block_until_ready``."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _same_pads(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one axis: the output has ceil(n / stride)
    elements, the pad is split low = total // 2, high = the rest."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv2d(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """2-D cross-correlation of one image with one odd kernel, "SAME"."""
    return F.conv2d(x[None, None], k[None, None],
                    padding=(k.shape[0] // 2, k.shape[1] // 2))[0, 0]


# --------------------------------------------------------------------------- #
# applications 0-2: pure kernels                                               #
# --------------------------------------------------------------------------- #


def _direct_conv(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Full 2-D convolution: the flipped kernel, padded by its size - 1."""
    return F.conv2d(x[None, None], k.flip(0, 1)[None, None],
                    padding=(k.shape[0] - 1, k.shape[1] - 1))[0, 0]


def bench_convolution(prof: OpProfiler, device) -> None:
    """App 0: SciPy-style full 2-D convolution of two 100x100 arrays
    (direct form, like scipy.signal.convolve2d)."""
    a = _normal(0, (100, 100), device)
    b = _normal(0, (100, 100), device)
    for _ in range(4):
        prof.run("conv", _direct_conv, a, b)


def bench_fourier_transform(prof: OpProfiler, device) -> None:
    """App 1: 2-D FFT over a large array (paper: 5000^2; here 1500^2)."""
    a = _normal(1, (1500, 1500), device)
    prof.run("fft", torch.fft.fft2, a)


def bench_wiener_filter(prof: OpProfiler, device) -> None:
    """App 2: Wiener filter = two box-filter correlations + pointwise."""
    img = _normal(2, (800, 800), device)
    box = torch.ones((5, 5), device=device) / 25.0
    mean = prof.run("conv", _conv2d, img, box)
    sq_mean = prof.run("conv", _conv2d, img * img, box)
    var = sq_mean - mean ** 2
    noise = torch.mean(var)
    out = mean + torch.clamp(var - noise, min=0) / torch.clamp(
        var, min=1e-9) * (img - mean)
    _ready(out)


# --------------------------------------------------------------------------- #
# applications 3-19: LightPipes-style optics sims                              #
# --------------------------------------------------------------------------- #


def bench_airy_beam(prof: OpProfiler, device) -> None:
    f = op.begin(10e-3, _WL, 512, device)
    x, y = f.grid()
    sc = 1.2e-3
    airy = torch.exp(-(x + y) / (4 * sc))  # exponential apodization
    f = op.Field(f.u * airy, f.size_m, f.wavelength)
    f = op.circ_screen(f, 0.4e-3)          # obstruction: beam self-heals
    for _ in range(6):
        f = op.forvard(f, 0.05, prof)
        _ = op.intensity(f)


def bench_youngs_experiment(prof: OpProfiler, device) -> None:
    f = op.begin(5e-3, _WL, 512, device)
    f = op.rect_slits(f, 0.06e-3, 2e-3, [(-0.3e-3, 0), (0.3e-3, 0)])
    f = op.forvard(f, 0.5, prof)
    _ = op.intensity(f)


def bench_poisson_to_bessel(prof: OpProfiler, device) -> None:
    f = op.begin(8e-3, _WL, 512, device)
    f = op.circ_screen(f, 1.0e-3)
    for z in (0.2, 0.4, 0.8, 1.6):
        g = op.forvard(f, z, prof)
        _ = op.intensity(g)


def bench_bessel_annular_slit(prof: OpProfiler, device) -> None:
    f = op.begin(8e-3, _WL, 512, device)
    f = op.circ_aperture(f, 1.5e-3)
    g = op.circ_screen(f, 1.4e-3)           # annulus
    g = op.lens(g, 0.5)
    for z in (0.3, 0.5, 0.7):
        h = op.forvard(g, z, prof)
        _ = op.intensity(h)


def bench_bessel_axicon(prof: OpProfiler, device) -> None:
    f = op.begin(8e-3, _WL, 512, device)
    f = op.gauss(f, 2e-3)
    f = op.axicon(f, 0.01)
    for z in (0.1, 0.2, 0.3):
        g = op.forvard(f, z, prof)
        _ = op.intensity(g)


def bench_multi_holes_slits(prof: OpProfiler, device) -> None:
    f = op.begin(5e-3, _WL, 512, device)
    centers = [(dx * 1e-4, dy * 1e-4) for dx in (-4, 0, 4) for dy in (-4, 0, 4)]
    f = op.rect_slits(f, 0.05e-3, 0.05e-3, centers)
    f = op.forvard(f, 1.0, prof)
    _ = op.intensity(f)


def bench_circular_aperture(prof: OpProfiler, device) -> None:
    f = op.begin(5e-3, _WL, 512, device)
    f = op.circ_aperture(f, 0.5e-3)
    f = op.forvard(f, 0.8, prof)
    _ = op.intensity(f)


def bench_shack_hartmann(prof: OpProfiler, device) -> None:
    f = op.begin(10e-3, _WL, 512, device)
    x, y = f.grid()
    aberration = torch.exp(1j * 40 * (x / 5e-3) ** 3)   # coma-like wavefront
    f = op.Field(f.u * aberration, f.size_m, f.wavelength)
    f = op.lenslet_array(f, 1e-3, 0.05)
    f = op.forvard(f, 0.05, prof)
    spots = op.intensity(f)
    # centroid readout per lenslet (non-accelerable)
    s = spots.reshape(8, 64, 8, 64)
    w = s.sum((1, 3))
    _ready(w / torch.clamp(w.sum(), min=1e-9))


def bench_spot_of_poisson(prof: OpProfiler, device) -> None:
    f = op.begin(8e-3, _WL, 512, device)
    f = op.circ_screen(f, 1.0e-3)
    f = op.forvard(f, 1.0, prof)
    _ = op.intensity(f)


def bench_fresnel_zone_plate(prof: OpProfiler, device) -> None:
    f = op.begin(6e-3, _WL, 512, device)
    f = op.zone_plate(f, 0.5)
    f = op.forvard(f, 0.5, prof)
    _ = op.intensity(f)


def bench_unstable_resonator(prof: OpProfiler, device) -> None:
    f = op.begin(10e-3, _WL, 256, device)
    for _ in range(8):                       # round trips
        f = op.circ_aperture(f, 2.5e-3)
        f = op.lens(f, -0.75)
        f = op.forvard(f, 0.5, prof)
        f = op.lens(f, 1.5)
        f = op.forvard(f, 0.5, prof)
        u = f.u / torch.clamp(torch.max(f.u.abs()), min=1e-9)
        f = op.Field(u, f.size_m, f.wavelength)
    _ = op.intensity(f)


def bench_doughnut_collinear(prof: OpProfiler, device) -> None:
    f = op.begin(6e-3, _WL, 512, device)
    d = op.spiral_phase_plate(op.gauss(f, 1.5e-3), charge=1)
    d = op.forvard(d, 0.3, prof)
    g = op.gauss(f, 1.5e-3)
    g = op.forvard(g, 0.3, prof)
    for phase in np.linspace(0, 2 * np.pi, 12):
        fringe = (d.u + cmath.exp(1j * phase) * g.u).abs() ** 2
    _ready(fringe)


def bench_michelson(prof: OpProfiler, device) -> None:
    f = op.begin(6e-3, _WL, 512, device)
    f = op.gauss(f, 2e-3)
    arm1 = op.forvard(f, 0.30, prof)
    for dz in np.linspace(0, _WL, 8):
        arm2 = op.Field(arm1.u * cmath.exp(2j * np.pi * dz / _WL),
                        f.size_m, f.wavelength)
        fringe = (arm1.u + arm2.u).abs() ** 2
    _ready(fringe)


def bench_phase_recovery(prof: OpProfiler, device) -> None:
    """Gerchberg-Saxton: iterative forward/backward FFTs + constraints."""
    target = _normal(3, (256, 256), device).abs()
    field = torch.exp(1j * _uniform(3, (256, 256), device) * 2 * np.pi)
    for _ in range(15):
        far = prof.run("fft", torch.fft.fft2, field)
        far = target * far / torch.clamp(far.abs(), min=1e-9)
        near = prof.run("fft", torch.fft.ifft2, far)
        field = near / torch.clamp(near.abs(), min=1e-9)
        # host-side constraint bookkeeping (non-accelerable)
        err = torch.mean((far.abs() - target) ** 2)
        _ready(err)


def bench_spiral_phase_plate(prof: OpProfiler, device) -> None:
    f = op.begin(6e-3, _WL, 512, device)
    f = op.gauss(f, 1.5e-3)
    f = op.spiral_phase_plate(f, charge=1)
    f = op.forvard(f, 0.5, prof)
    _ = op.intensity(f)
    # mode purity analysis (non-accelerable azimuthal decomposition)
    x, y = f.grid()
    theta = torch.atan2(y, x)
    for m in range(-2, 3):
        _ready(torch.sum(f.u * torch.exp(-1j * m * theta)).abs() ** 2)


def bench_hermite_to_laguerre(prof: OpProfiler, device) -> None:
    f = op.begin(8e-3, _WL, 256, device)
    f = op.hermite_gauss(f, 1, 0, 1.5e-3)
    # astigmatic mode converter: two cylindrical lenses
    x, y = f.grid()
    k = 2 * np.pi / _WL
    for _ in range(2):
        f = op.Field(f.u * torch.exp(-1j * k * x ** 2 / (2 * 0.5)), f.size_m,
                     _WL)
        f = op.forvard(f, 0.35, prof)
    _ = op.intensity(f)
    # overlap with target LG mode (non-accelerable)
    r2 = x ** 2 + y ** 2
    lg = (x + 1j * y) * torch.exp(-r2 / (1.5e-3) ** 2)
    _ready(torch.vdot(lg.flatten(), f.u.flatten()).abs() ** 2)


def bench_doughnut_tilted(prof: OpProfiler, device) -> None:
    f = op.begin(6e-3, _WL, 512, device)
    d = op.spiral_phase_plate(op.gauss(f, 1.5e-3), charge=1)
    d = op.forvard(d, 0.2, prof)
    g = op.tilt(op.gauss(f, 1.5e-3), 2e-4, 0.0)
    # many interference/analysis frames, single propagation: low fft share
    for phase in np.linspace(0, 2 * np.pi, 40):
        fr = (d.u + cmath.exp(1j * phase) * g.u).abs() ** 2
        _ready(fr / torch.clamp(fr.max(), min=1e-9))


# --------------------------------------------------------------------------- #
# applications 20-22: Prysm-style                                              #
# --------------------------------------------------------------------------- #


def bench_double_slit_prysm(prof: OpProfiler, device) -> None:
    f = op.begin(4e-3, _WL, 384, device)
    f = op.rect_slits(f, 0.05e-3, 1.5e-3, [(-0.25e-3, 0), (0.25e-3, 0)])
    ff = op.far_field(f, prof)
    psf = ff.abs() ** 2
    _ready(psf / psf.max())


def bench_first_diffraction_model(prof: OpProfiler, device) -> None:
    f = op.begin(4e-3, _WL, 384, device)
    f = op.circ_aperture(f, 0.8e-3)
    ff = op.far_field(f, prof)
    psf = ff.abs() ** 2
    mtf = prof.run("fft", torch.fft.fft2, psf)
    _ready(mtf.abs() / mtf.abs().max())


def _fft_conv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Circular convolution through the FFT."""
    return torch.fft.ifft2(torch.fft.fft2(a) * torch.fft.fft2(b)).real


def bench_image_simulation(prof: OpProfiler, device) -> None:
    """End-to-end Siemens-star imaging: optics PSF + detector chain."""
    n = 384
    # object: Siemens star (pure host math)
    lin = torch.linspace(-1, 1, n, device=device)
    xx, yy = torch.meshgrid(lin, lin, indexing="xy")
    theta = torch.atan2(yy, xx)
    star = 0.5 * (1 + torch.sign(torch.sin(24 * theta)))
    # optics: aberrated pupil -> PSF
    f = op.begin(4e-3, _WL, n, device)
    f = op.circ_aperture(f, 1.0e-3)
    x, y = f.grid()
    f = op.Field(f.u * torch.exp(1j * 8 * (x / 1e-3) ** 2 * (y / 1e-3)),
                 f.size_m, _WL)
    psf = op.far_field(f, prof).abs() ** 2
    psf = psf / psf.sum()
    # image formation: conv via FFT (accelerable)
    img = prof.run("conv", _fft_conv, star, torch.fft.ifftshift(psf))
    # detector chain (non-accelerable): sampling, shot/read noise, quantize
    ds = img.reshape(n // 4, 4, n // 4, 4).mean((1, 3))
    ds = ds + 0.01 * _normal(4, ds.shape, device)
    ds = torch.clamp(ds / torch.clamp(ds.max(), min=1e-9), 0, 1)
    q = torch.round(ds * 4095) / 4095
    for _ in range(6):      # radiometric calibration sweeps
        g = (q - q.min()) / torch.clamp(q.max() - q.min(), min=1e-9)
        _ready(g ** 2.2)


# --------------------------------------------------------------------------- #
# applications 23-26: ML workloads                                             #
# --------------------------------------------------------------------------- #


def _cnn_params(seed: int, device) -> dict[str, torch.Tensor]:
    k = [_fold_in(seed, i) for i in range(4)]
    return {
        "c1": 0.1 * _normal(k[0], (16, 3, 5, 5), device),
        "c2": 0.1 * _normal(k[1], (32, 16, 5, 5), device),
        "w1": 0.1 * _normal(k[2], (32 * 8 * 8, 64), device),
        "w2": 0.1 * _normal(k[3], (64, 10), device),
    }


def _conv_same(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return F.conv2d(a, w, padding=(w.shape[2] // 2, w.shape[3] // 2))


def _cnn_forward(prof: OpProfiler | None, p: dict, x: torch.Tensor):
    run = ((lambda f, *a: prof.run("conv", f, *a)) if prof
           else (lambda f, *a: f(*a)))
    h = torch.relu(run(_conv_same, x, p["c1"]))
    h = F.max_pool2d(h, 2, 2)
    h = torch.relu(run(_conv_same, h, p["c2"]))
    h = F.max_pool2d(h, 2, 2)
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(h @ p["w1"])
    return h @ p["w2"]


def bench_cnn_inference(prof: OpProfiler, device) -> None:
    """App 23: CIFAR-style convnet inference (conv accelerable)."""
    p = _cnn_params(5, device)
    x = _normal(6, (64, 3, 32, 32), device)
    logits = _cnn_forward(prof, p, x)
    _ready(torch.softmax(logits, -1))


def bench_cnn_training(prof: OpProfiler, device) -> None:
    """App 24: one training epoch-slice: fwd is bracketed per-conv; the
    entire backward + SGD update is host ('other') work, mirroring the
    paper's finding that training accelerates far less than inference."""
    p = _cnn_params(7, device)
    x = _normal(8, (64, 3, 32, 32), device)
    yl = torch.randint(0, 10, (64,), generator=_gen(9, device),
                       device=device)

    def loss_fn(p):
        lg = _cnn_forward(None, p, x)
        return -torch.mean(torch.log_softmax(lg, -1)[torch.arange(
            64, device=device), yl])

    for _ in range(2):
        _ = _cnn_forward(prof, p, x)                  # measured fwd convs
        leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
        g = torch.autograd.grad(loss_fn(leaves), list(leaves.values()))
        p = {k: (v - 0.01 * gk).detach()             # backward: 'other'
             for (k, v), gk in zip(p.items(), g)}
        _ready(p["c1"])


def bench_audio_resampling(prof: OpProfiler, device) -> None:
    """App 25: sinc-kernel resampling of a batch of waveforms (1-D conv)."""
    wav = _normal(10, (4, 1, 48_000), device)
    t = torch.arange(-64, 65, device=device) / 48_000
    sinc = torch.sinc(2 * 16_000 * t) * torch.hann_window(
        129, periodic=False, device=device)
    kern = sinc[None, None, :]
    pads = _same_pads(wav.shape[-1], kern.shape[-1], 3)

    def conv(a: torch.Tensor) -> torch.Tensor:
        # the kernel follows the input, so a call can be replayed elsewhere
        return F.conv1d(F.pad(a, pads), kern.to(a.device), stride=3)

    out = prof.run("conv", conv, wav)
    # host: normalization + envelope checks
    _ready(out / torch.clamp(out.abs().max(), min=1e-9))


def _conv_gelu(a: torch.Tensor, w: torch.Tensor, *, stride: int
               ) -> torch.Tensor:
    return F.gelu(F.conv1d(a, w, stride=stride), approximate="tanh")


def bench_wav2vec2_inference(prof: OpProfiler, device) -> None:
    """App 26: conv feature extractor (accelerable) + small transformer
    encoder (matmuls: host under a Fourier/conv accelerator)."""
    key = 11
    wav = _normal(key, (1, 1, 32_000), device)
    convs = []
    cin = 1
    for i, (cout, kw, st) in enumerate([(64, 10, 5), (64, 3, 2), (64, 3, 2),
                                        (64, 2, 2)]):
        convs.append(0.1 * _normal(_fold_in(key, i), (cout, cin, kw), device))
        cin = cout
    h = wav
    for i, w in enumerate(convs):
        st = [5, 2, 2, 2][i]
        h = prof.run("conv", functools.partial(_conv_gelu, stride=st), h, w)
    x = h.transpose(1, 2)                            # (1, T, 64)
    for i in range(4):                               # encoder layers: 'other'
        kq = 0.1 * _normal(_fold_in(key, 100 + i), (64, 64), device)
        att = torch.softmax((x @ kq) @ (x @ kq).transpose(1, 2) / 8.0, -1)
        x = x + att @ (x @ kq)
        x = x + F.gelu(x @ kq, approximate="tanh") @ kq.T
    _ready(x)


# --------------------------------------------------------------------------- #
# the suite                                                                    #
# --------------------------------------------------------------------------- #

BENCHMARKS = [
    ("convolution", bench_convolution),
    ("fourier_transform", bench_fourier_transform),
    ("wiener_filter", bench_wiener_filter),
    ("airy_beam", bench_airy_beam),
    ("youngs_experiment", bench_youngs_experiment),
    ("poisson_to_bessel", bench_poisson_to_bessel),
    ("bessel_annular_slit", bench_bessel_annular_slit),
    ("bessel_axicon", bench_bessel_axicon),
    ("multi_holes_slits", bench_multi_holes_slits),
    ("circular_aperture", bench_circular_aperture),
    ("shack_hartmann", bench_shack_hartmann),
    ("spot_of_poisson", bench_spot_of_poisson),
    ("fresnel_zone_plate", bench_fresnel_zone_plate),
    ("unstable_resonator", bench_unstable_resonator),
    ("doughnut_collinear", bench_doughnut_collinear),
    ("michelson", bench_michelson),
    ("phase_recovery", bench_phase_recovery),
    ("spiral_phase_plate", bench_spiral_phase_plate),
    ("hermite_to_laguerre", bench_hermite_to_laguerre),
    ("doughnut_tilted", bench_doughnut_tilted),
    ("double_slit_prysm", bench_double_slit_prysm),
    ("first_diffraction_model", bench_first_diffraction_model),
    ("image_simulation", bench_image_simulation),
    ("cnn_inference", bench_cnn_inference),
    ("cnn_training", bench_cnn_training),
    ("audio_resampling", bench_audio_resampling),
    ("wav2vec2_inference", bench_wav2vec2_inference),
]


def _pin_fp32(device: torch.device) -> None:
    """cuDNN convolutions default to TF32; the reference computes in fp32."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def run_one(name: str, fn, repeats: int = REPEATS,
            device: str | torch.device = "cuda",
            profiler=OpProfiler) -> AmdahlReport:
    """Warm ``fn`` up once, then time ``repeats`` runs under one
    ``profiler()`` session: the row of Table 1."""
    device = torch.device(device)
    _pin_fp32(device)
    fn(profiler(), device)      # warm-up: FFT plans, conv algorithms, memory
    prof = profiler()
    prof.start()
    for _ in range(repeats):
        fn(prof, device)
    prof.stop()
    return report(name, prof.accelerable_s(("fft", "conv")), prof.total_s)


def run_suite(repeats: int = REPEATS, device: str | torch.device = "cuda",
              profiler=OpProfiler) -> list[AmdahlReport]:
    """Every benchmark in Table 1's order.  ``profiler`` is the
    ``OpProfiler`` class each run is measured with (a subclass may record
    the bracketed calls)."""
    return [run_one(name, fn, repeats, device, profiler)
            for name, fn in BENCHMARKS]
