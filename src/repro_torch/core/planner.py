"""Conversion-aware offload planner (the paper's §4–§6 decision rule, executable).

Given a per-category workload profile (host seconds + boundary sample counts)
and an analog accelerator spec, the planner:

  1. prices each accelerable category on the accelerator *including* the
     DAC/ADC + interface costs (the paper's whole point — never price the
     analog compute alone);
  2. offloads a category only when the priced accelerator time beats the host
     AND its observed quantization error (``CategoryProfile.rel_err``, fed by
     the runtime's fidelity shadowing) stays inside the budget implied by the
     converters' ENOB — the paper's argument cuts both ways: skimping on
     conversion buys speed by spending accuracy, and a category whose error
     blows the bound must not be offloaded no matter how fast it runs
     (``OffloadDecision.fidelity_bound`` records the veto);
  3. reports the end-to-end Amdahl speedup, the zero-cost ideal bound
     (paper Table 1), and the verdict against the 10x build-threshold (§5).

The same machinery runs against the 27-benchmark suite (time-profiled) and
the 10 assigned LM architectures (FLOP-profiled via
``repro_torch.core.profiler.flops_by_category``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.core import amdahl
from repro_torch.core.accelerator import (
    OpticalFourierAcceleratorSpec,
    OpticalMVMAcceleratorSpec,
)
from repro_torch.core.conversion import enob_error_bound

__all__ = [
    "CategoryProfile",
    "OffloadDecision",
    "OffloadPlan",
    "plan_offload",
    "BUILD_THRESHOLD",
]

# §5: accelerators must deliver >= 10x on a metric users care about.
BUILD_THRESHOLD = 10.0


@dataclasses.dataclass(frozen=True)
class CategoryProfile:
    """Workload of one op category over a full application run.

    host_s: wall time the host spends in this category.
    calls: number of accelerator invocations offload would require.
    samples_in / samples_out: scalars crossing the conversion boundary per
      *run* (summed over calls).
    host_post_s: digital post-processing that offload cannot remove (e.g.
      the host-side inverse FFT of the 4f convolution pipeline).
    rel_err: observed relative error of this category's offloaded execution
      (worst ``FidelityChecker`` shadow score), or None when never shadowed.
      Fed by ``PlanRouter.replan`` so a category whose measured error blows
      the converters' ENOB budget is fidelity-gated off the accelerator.
    """

    name: str
    host_s: float
    calls: int = 1
    samples_in: int = 0
    samples_out: int = 0
    host_post_s: float = 0.0
    rel_err: float | None = None


@dataclasses.dataclass(frozen=True)
class OffloadDecision:
    category: str
    host_s: float
    accel_s: float          # conversion + interface + analog + residual host
    conversion_s: float     # DAC+ADC share of accel_s
    offload: bool
    # True when the category's observed rel_err exceeds the ENOB budget:
    # offload is vetoed on accuracy grounds regardless of speedup.
    fidelity_bound: bool = False

    @property
    def category_speedup(self) -> float:
        if not self.offload or self.accel_s <= 0:
            return 1.0
        return self.host_s / self.accel_s


@dataclasses.dataclass(frozen=True)
class OffloadPlan:
    accelerator: str
    decisions: tuple[OffloadDecision, ...]
    total_host_s: float
    total_planned_s: float

    @property
    def end_to_end_speedup(self) -> float:
        if self.total_planned_s <= 0:
            return math.inf
        return self.total_host_s / self.total_planned_s

    @property
    def offloaded_fraction(self) -> float:
        if self.total_host_s <= 0:
            return 0.0
        off = sum(d.host_s for d in self.decisions if d.offload)
        return min(off / self.total_host_s, 1.0)

    @property
    def ideal_speedup(self) -> float:
        """Paper Table 1 column: zero-cost accelerator Amdahl bound."""
        return amdahl.ideal_speedup(self.offloaded_fraction)

    @property
    def worthwhile(self) -> bool:
        return self.end_to_end_speedup >= BUILD_THRESHOLD

    @property
    def conversion_bound(self) -> bool:
        """True when conversion dominates planned accelerator time."""
        conv = sum(d.conversion_s for d in self.decisions if d.offload)
        acc = sum(d.accel_s for d in self.decisions if d.offload)
        return acc > 0 and conv / acc > 0.5

    @property
    def fidelity_bound(self) -> bool:
        """True when any category was vetoed on accuracy: its observed
        quantization error exceeds the converters' ENOB budget, so it stays
        on the host regardless of speedup."""
        return any(d.fidelity_bound for d in self.decisions)

    def summary(self) -> str:
        rows = [f"plan[{self.accelerator}] speedup={self.end_to_end_speedup:.2f}x "
                f"(ideal={self.ideal_speedup:.2f}x, f={self.offloaded_fraction:.2%}, "
                f"worthwhile={self.worthwhile}, "
                f"conversion_bound={self.conversion_bound}, "
                f"fidelity_bound={self.fidelity_bound})"]
        for d in self.decisions:
            gate = " FIDELITY-GATED" if d.fidelity_bound else ""
            rows.append(f"  {d.category:>8}: host={d.host_s:.4g}s "
                        f"accel={d.accel_s:.4g}s (conv {d.conversion_s:.4g}s) "
                        f"offload={d.offload}{gate}")
        return "\n".join(rows)


_SUPPORTS: Mapping[type, tuple[str, ...]] = {
    OpticalFourierAcceleratorSpec: ("fft", "conv"),
    OpticalMVMAcceleratorSpec: ("matmul",),
}


def _price(spec, prof: CategoryProfile,
           max_batch: int = 1) -> tuple[float, float]:
    """Accelerator wall time and its conversion share for one category.

    With ``max_batch > 1`` the category's calls are priced as coalesced
    invocations of up to ``max_batch`` same-shape calls each (the runtime
    executor's batching): fixed per-invocation boundary costs amortize, so
    the verdict reflects how the offload would actually be executed.
    """
    if prof.calls <= 0:
        return 0.0, 0.0
    n_in = max(prof.samples_in // prof.calls, 1)
    n_out = max(prof.samples_out // prof.calls, 1) if prof.samples_out else n_in
    batch = max(min(max_batch, prof.calls), 1)
    if batch > 1 and hasattr(spec, "batched_step_cost"):
        full, rem = divmod(prof.calls, batch)
        total = conv = 0.0
        for b, count in ((batch, full), (rem, 1 if rem else 0)):
            if count:
                cost = spec.batched_step_cost(n_in, n_out, batch=b)
                total += cost.total_s * count
                conv += cost.conversion_s * count
        return total + prof.host_post_s, conv
    cost = spec.step_cost(n_in, n_out)
    total = cost.total_s * prof.calls + prof.host_post_s
    return total, cost.conversion_s * prof.calls


def plan_offload(profiles: Sequence[CategoryProfile],
                 spec: OpticalFourierAcceleratorSpec | OpticalMVMAcceleratorSpec,
                 *, max_batch: int | Mapping[str, int] = 1,
                 fidelity_slack: float = 16.0) -> OffloadPlan:
    """Price every category on ``spec`` and keep only profitable offloads.

    ``max_batch=1`` (default) is the paper's serial one-call-per-crossing
    model; a larger int prices the runtime's batched execution uniformly,
    and a ``{category: batch}`` mapping prices each category at its own
    coalescing depth (absent categories price serially).

    Offload is additionally *fidelity-gated*: a profile carrying an
    observed ``rel_err`` above the relative-error budget implied by the
    spec's limiting converter ENOB (``enob_error_bound``, widened by
    ``fidelity_slack`` — the ``FidelityChecker`` default) is kept on the
    host even when the accelerator is faster, and its decision records
    ``fidelity_bound=True``.  Profiles without an observed error (never
    shadowed) are gated on speed alone, as before.
    """
    supported = ()
    for klass, cats in _SUPPORTS.items():
        if isinstance(spec, klass):
            supported = cats
            break
    enob = min(spec.dac.effective_bits, spec.adc.effective_bits)
    err_budget = enob_error_bound(enob, fidelity_slack)
    decisions = []
    total_host = 0.0
    total_planned = 0.0
    for prof in profiles:
        total_host += prof.host_s
        if prof.name in supported and prof.host_s > 0:
            cat_batch = max_batch.get(prof.name, 1) \
                if isinstance(max_batch, Mapping) else max_batch
            accel_s, conv_s = _price(spec, prof, cat_batch)
            fidelity_bound = (prof.rel_err is not None
                              and prof.rel_err > err_budget)
            offload = accel_s < prof.host_s and not fidelity_bound
            decisions.append(OffloadDecision(
                category=prof.name, host_s=prof.host_s, accel_s=accel_s,
                conversion_s=conv_s, offload=offload,
                fidelity_bound=fidelity_bound))
            total_planned += accel_s if offload else prof.host_s
        else:
            decisions.append(OffloadDecision(
                category=prof.name, host_s=prof.host_s, accel_s=math.inf,
                conversion_s=0.0, offload=False))
            total_planned += prof.host_s
    return OffloadPlan(accelerator=spec.name, decisions=tuple(decisions),
                       total_host_s=total_host, total_planned_s=total_planned)
