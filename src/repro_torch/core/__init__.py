"""The paper's contribution as a composable library (PyTorch port).

Subsystems:
  conversion  — DAC/ADC design-point models + survey Pareto envelope (§2, Fig. 2)
  accelerator — analog accelerator specs + step cost models (Fig. 7a, Fig. 8)
  optical     — differentiable 4f Fourier/convolution physics sim (App. A/B)
  amdahl      — Eq. 2/3 speedup machinery (App. C.2)
  complexity  — compute vs conversion complexity C=2N (§4, Fig. 3)
  profiler    — wall-time + dispatch-mode FLOP attribution by op category (App. C.1)
  planner     — the conversion-aware offload decision rule (§4–§6)
"""

from repro_torch.core.accelerator import (
    ANDERSON_MVM,
    IDEAL_4F,
    PROTOTYPE_4F,
    OpticalFourierAcceleratorSpec,
    OpticalMVMAcceleratorSpec,
    StepCost,
)
from repro_torch.core.amdahl import (AmdahlReport, ideal_speedup, report,
                                     required_fraction, speedup)
from repro_torch.core.conversion import (
    KIM_2019_DAC,
    LIU_2022_ADC,
    ConverterSpec,
    conversion_complexity,
    frontier_gap,
    pareto_fom_fj,
    pareto_power_w,
)
from repro_torch.core.optical import (
    IDEAL_SIM,
    OpticalSimParams,
    fourier_mask_for_kernel,
    optical_conv2d,
    optical_fft2_complex,
    optical_fft2_magnitude,
)
from repro_torch.core.planner import (
    BUILD_THRESHOLD,
    CategoryProfile,
    OffloadPlan,
    plan_offload,
)
from repro_torch.core.profiler import OpProfiler, flops_by_category

__all__ = [k for k in dir() if not k.startswith("_")]
