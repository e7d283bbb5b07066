"""Figure 8 reproduction: prototype optical FT vs software FFT.

The twin of the reference's ``benchmarks/conversion_bottleneck.py``.  The
software side is *measured*: ``torch.fft.fft2`` of the same 1024x768
frame on the caller's device, each repeat waited for.  The hardware side
is the calibrated component model of the prototype
(``repro_torch.core.accelerator.PROTOTYPE_4F``), whose constants were fit
to the paper's measured totals: 5.209 s end-to-end, 99.599 % of it data
movement, 23.8x slower than the software FFT on the Raspberry Pi 4 host.

Also runs the simulated accelerator *functionally*
(``repro_torch.core.optical``) on a reduced frame to demonstrate the
computation the hardware performs.
"""

from __future__ import annotations

import time

import torch

from repro_torch.core.accelerator import PROTOTYPE_4F
from repro_torch.core.optical import OpticalSimParams, optical_fft2_magnitude

__all__ = ["run"]

FRAME = (1024, 768)
PAPER_SOFTWARE_S = 0.219
PAPER_HARDWARE_S = 5.209
PAPER_MOVEMENT_PCT = 99.599
REPS = 5


def _fft2_waited(a: torch.Tensor) -> None:
    torch.fft.fft2(a)
    if a.is_cuda:
        torch.cuda.synchronize(a.device)


def run(device: str | torch.device = "cuda") -> dict:
    device = torch.device(device)
    # measured software FFT on this device
    gen = torch.Generator(device=device)
    a = torch.rand(FRAME, generator=gen.manual_seed(0), device=device)
    _fft2_waited(a)                               # warm-up: the FFT plan
    t0 = time.perf_counter()
    for _ in range(REPS):
        _fft2_waited(a)
    sw_s = (time.perf_counter() - t0) / REPS

    # modeled prototype hardware cost for the same frame
    cost = PROTOTYPE_4F.step_cost(FRAME[0] * FRAME[1])

    # functional sim on a reduced frame (the physics the hardware performs).
    # 16-bit detector: the DC peak of a natural frame sits ~14 bits above
    # the AC spectrum.
    params = OpticalSimParams(dac_bits=8, adc_bits=16)
    small = torch.rand((256, 192), generator=gen.manual_seed(1),
                       device=device)
    mag = optical_fft2_magnitude(small, params)
    oracle = torch.fft.fft2(small, norm="ortho").abs()
    i_err = float(torch.mean((mag ** 2 - oracle ** 2).abs())
                  / torch.clamp(torch.mean(oracle ** 2), min=1e-12))

    return {
        "software_fft_s": sw_s,
        "hardware_total_s": cost.total_s,
        "hardware_movement_pct": 100 * cost.data_movement_fraction,
        "hardware_vs_software": cost.total_s / sw_s,
        "paper_hardware_vs_software": PAPER_HARDWARE_S / PAPER_SOFTWARE_S,
        "paper_movement_pct": PAPER_MOVEMENT_PCT,
        "sim_intensity_rel_err": i_err,
        "breakdown": {
            "dac_s": cost.dac_s, "adc_s": cost.adc_s,
            "interface_s": cost.interface_s, "analog_s": cost.analog_s,
        },
    }
