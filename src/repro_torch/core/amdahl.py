"""Amdahl's-law machinery (paper Appendix C.2, Eq. 2/3).

Pure Python, no tensors: these run inside benchmark drivers and the planner.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "speedup",
    "ideal_speedup",
    "required_fraction",
    "AmdahlReport",
    "report",
]


def speedup(f_accelerate: float, p: float = math.inf) -> float:
    """Eq. 2: S = 1 / (f_fixed + f_accelerate / P).

    ``f_accelerate`` is the fraction of execution time the accelerator can
    absorb, ``p`` the factor by which that fraction is accelerated.
    """
    if not 0.0 <= f_accelerate <= 1.0:
        raise ValueError(f"f_accelerate must be in [0,1], got {f_accelerate}")
    if p <= 0:
        raise ValueError("p must be positive")
    f_fixed = 1.0 - f_accelerate
    denom = f_fixed + f_accelerate / p
    if denom == 0.0:
        return math.inf
    return 1.0 / denom


def ideal_speedup(f_accelerate: float) -> float:
    """Eq. 3: S ~= 1 / f_fixed — the zero-cost-accelerator bound."""
    return speedup(f_accelerate, math.inf)


def required_fraction(target_speedup: float) -> float:
    """Fraction that must be accelerable to ever reach ``target_speedup``.

    The paper's 10x rule (§5): S >= 10 requires f_accelerate >= 0.9.
    """
    if target_speedup < 1.0:
        raise ValueError("target_speedup must be >= 1")
    if math.isinf(target_speedup):
        return 1.0
    return 1.0 - 1.0 / target_speedup


@dataclasses.dataclass(frozen=True)
class AmdahlReport:
    """One row of the paper's Table 1."""

    name: str
    accel_time_s: float        # FFT/conv (offloadable) time
    total_time_s: float
    @property
    def fraction(self) -> float:
        return 0.0 if self.total_time_s == 0 else self.accel_time_s / self.total_time_s

    @property
    def end_to_end_speedup(self) -> float:
        return ideal_speedup(min(self.fraction, 1.0))

    def row(self) -> str:
        return (f"{self.name},{self.accel_time_s:.6f},{self.total_time_s:.6f},"
                f"{100.0 * self.fraction:.2f},{self.end_to_end_speedup:.2f}")


def report(name: str, accel_time_s: float, total_time_s: float) -> AmdahlReport:
    if accel_time_s < 0 or total_time_s < 0:
        raise ValueError("times must be non-negative")
    if accel_time_s > total_time_s:
        # Profiling noise can put the category marginally above the total.
        accel_time_s = total_time_s
    return AmdahlReport(name=name, accel_time_s=accel_time_s, total_time_s=total_time_s)
