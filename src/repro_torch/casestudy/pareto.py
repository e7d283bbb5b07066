"""Figure 2 / §2 reproduction: the DAC/ADC Pareto frontier and the
Anderson-et-al. feasibility check.  The twin of the reference's
``benchmarks/pareto.py``.

Sweeps the survey-envelope model across sampling rates, places the paper's
two reference converters (Kim DAC, Liu ADC) against it, and computes how
far below the frontier the 32x-lower-energy converters assumed by the
optical-transformer energy claims would need to sit.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.conversion import (
    KIM_2019_DAC,
    LIU_2022_ADC,
    ConverterSpec,
    frontier_gap,
    pareto_fom_fj,
    pareto_power_w,
)

__all__ = ["run"]


def run() -> dict:
    rates = np.logspace(6, 11, 26)
    envelope = {
        "adc_fj": [pareto_fom_fj(r, "adc") for r in rates],
        "dac_fj": [pareto_fom_fj(r, "dac") for r in rates],
        "rates_hz": list(rates),
    }
    hyp_adc = dataclasses.replace(LIU_2022_ADC, name="anderson-adc",
                                  power_w=LIU_2022_ADC.power_w / 32)
    hyp_dac = dataclasses.replace(KIM_2019_DAC, name="anderson-dac",
                                  power_w=KIM_2019_DAC.power_w / 32)
    # power an on-frontier design would need at the paper's reference points
    return {
        "kim_dac_gap": frontier_gap(KIM_2019_DAC),      # ~1: on frontier
        "liu_adc_gap": frontier_gap(LIU_2022_ADC),      # ~1: on frontier
        "anderson_dac_gap": frontier_gap(hyp_dac),       # ~32: below frontier
        "anderson_adc_gap": frontier_gap(hyp_adc),
        "kim_energy_per_sample_pj": KIM_2019_DAC.energy_per_sample_j * 1e12,
        "liu_energy_per_sample_pj": LIU_2022_ADC.energy_per_sample_j * 1e12,
        "frontier_power_at_liu_point_w": pareto_power_w(
            LIU_2022_ADC.rate_hz, LIU_2022_ADC.effective_bits, "adc"),
        "envelope": envelope,
    }
