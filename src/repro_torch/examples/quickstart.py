"""Quickstart: the paper in five minutes.

The twin of the reference's ``examples/quickstart.py``:

1. Simulate the 4f optical accelerator computing an FFT and a convolution
   (physics vs digital oracle), on the CUDA card.
2. Price the same ops through the calibrated prototype cost model — see
   the data-conversion/data-movement bottleneck (Fig. 8).
3. Apply the planner's decision rule (§4-§6): when is offload worth it?

Each step is a function that returns the numbers it prints.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core import (
    IDEAL_4F,
    PROTOTYPE_4F,
    CategoryProfile,
    OpticalSimParams,
    fourier_mask_for_kernel,
    ideal_speedup,
    optical_conv2d,
    optical_fft2_magnitude,
    plan_offload,
)

ADC_BITS = (8, 12, 16)
FIG8_PIXELS = 1024 * 768


def image(seed: int = 0) -> np.ndarray:
    """The 64x64 frame the tour runs on, uniform in [0, 1)."""
    return np.random.default_rng(seed).random((64, 64), dtype=np.float32)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def physics(img: np.ndarray, device="cuda") -> dict:
    """Relative error of the optical |FFT| at each ADC width, and of the
    4-step interferometric convolution at 16 bits, against the digital
    oracle."""
    x = torch.tensor(img, device=device)
    oracle = torch.fft.fft2(x, norm="ortho").abs()
    # The detector ADC auto-ranges on the DC peak, which sits ~14 bits
    # above the AC spectrum of a natural image: converter resolution IS the
    # accelerator's accuracy — another face of the conversion bottleneck.
    fft_err = {}
    for adc_bits in ADC_BITS:
        params = OpticalSimParams(dac_bits=12, adc_bits=adc_bits)
        fft_err[adc_bits] = _rel(optical_fft2_magnitude(x, params), oracle)

    params = OpticalSimParams(dac_bits=12, adc_bits=16)
    kernel = torch.zeros(x.shape, device=device)
    kernel[0, 0], kernel[1, 1] = 0.6, 0.4
    blur = optical_conv2d(x, fourier_mask_for_kernel(kernel), params)
    ob = torch.fft.ifft2(torch.fft.fft2(x) * torch.fft.fft2(kernel)).real
    return {"fft_rel_err": fft_err, "conv_rel_err": _rel(blur, ob)}


def bottleneck(n: int = FIG8_PIXELS):
    """The prototype 4f engine's price of one ``n``-pixel frame."""
    return PROTOTYPE_4F.step_cost(n)


def decision() -> dict:
    """The offload plan of an application that is 60 % FFT time (a
    typical optics simulation, Table 1) on the ideal and the prototype
    engine."""
    profiles = [
        CategoryProfile("fft", host_s=0.6, calls=10,
                        samples_in=10 * 512 * 512, samples_out=10 * 512 * 512),
        CategoryProfile("other", host_s=0.4),
    ]
    return {spec.name: plan_offload(profiles, spec)
            for spec in (IDEAL_4F, PROTOTYPE_4F)}


def run(device="cuda") -> dict:
    """The tour: prints each step and returns its numbers."""
    print("=== 1. the physics: light computes the Fourier transform ===")
    phys = physics(image(), device)
    for bits, rel in phys["fft_rel_err"].items():
        print(f"  optical |FFT| vs digital oracle: rel error {rel:8.4f}  "
              f"({bits:2d}-bit ADC)")
    print(f"  optical conv (4-step interferometric, 16-bit ADC): rel error "
          f"{phys['conv_rel_err']:.4f}")

    print("\n=== 2. the bottleneck: pricing the same op end to end ===")
    cost = bottleneck()
    print(f"  prototype 4f, {FIG8_PIXELS} px frame: total {cost.total_s:.3f}s "
          f"of which {100 * cost.data_movement_fraction:.3f}% is data "
          f"movement")
    print(f"    DAC {cost.dac_s * 1e3:.2f}ms | ADC {cost.adc_s * 1e3:.2f}ms | "
          f"interface {cost.interface_s:.3f}s | optics "
          f"{cost.analog_s * 1e3:.1f}ms")
    print("  (paper Fig. 8: 5.209s, 99.599% movement, 23.8x slower than "
          "the software FFT)")

    print("\n=== 3. the decision rule: Amdahl with conversion costs ===")
    plans = decision()
    for name, plan in plans.items():
        print(f"  {name:13s}: end-to-end speedup "
              f"{plan.end_to_end_speedup:5.2f}x "
              f"(ideal Amdahl bound {plan.ideal_speedup:.2f}x, "
              f"worthwhile(>=10x)={plan.worthwhile})")
    print(f"  to reach 10x you must offload >= {100 * (1 - 1 / 10):.0f}% of "
          f"the application (paper §5): here only 60% is offloadable ->"
          f" bound {ideal_speedup(0.6):.1f}x.")
    return {"physics": phys, "fig8": cost, "plans": plans}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.examples.quickstart: no CUDA card available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    run(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
