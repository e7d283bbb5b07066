"""Counters, streaming percentile histograms, and the modeled-vs-measured
drift report.

Two halves:

* A tiny metrics kernel (:class:`Counter`, :class:`Histogram`,
  :class:`MetricsRegistry`) with the same mergeability contract
  ``RuntimeTelemetry.merge`` has: histograms use *fixed log-spaced bins*,
  so merging two histograms is exact bin-count addition (associative,
  commutative) — per-worker registries roll up without resampling.
  Percentiles (p50/p95/p99) come from a cumulative walk over the bins; the
  answer is the geometric midpoint of the rank's bin, clamped to the
  observed [min, max], so a single-sample histogram reports the sample
  itself exactly and every estimate carries at most one bin of relative
  error (~15% at the default 16 bins/decade — plenty for latency
  attribution spanning microseconds to seconds).

* :func:`drift_report`: joins each traced invocation's *measured* stage
  decomposition (from its span attributes) against the *modeled*
  ``batched_step_cost`` decomposition the planner priced, per stage:

    ========  =============================  ===========================
    stage     modeled (StepCost)             measured (span attrs)
    ========  =============================  ===========================
    hold      ``hold_s``                     scheduler hold (exact by
                                             construction — the sanity
                                             anchor, drift ~= 1)
    stage     ``dac_s + interface_s``        host staging + DAC-prep +
                                             dispatch (``stage_s``)
    compute   ``analog_s + adc_s + host_s``  in-flight device window
                                             (``compute_s``; the sim runs
                                             the ADC quantize inside the
                                             device computation, so the
                                             read-side conversion lands
                                             here)
    total     ``total_s``                    charged wall + hold
    ========  =============================  ===========================

  ``drift = measured / modeled``.  Drift below 1 on ``stage`` is the
  expected regime (the digital host stages frames faster than the modeled
  optical boundary would convert them — the headroom that makes offload
  worth planning); drift above 1 means the runtime's own overhead exceeds
  the boundary price it claims to amortize, which is exactly the
  divergence the CI gate fails on.  The worst-drifting stage (largest
  ``|log(drift)|``) is surfaced in ``PlanRouter.replan`` telemetry.

Zero dependencies beyond the stdlib; importable before torch is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, Mapping

__all__ = ["Counter", "Histogram", "MetricsRegistry",
           "StageDrift", "DriftReport", "drift_report"]


@dataclasses.dataclass
class Counter:
    """A monotone event count."""

    value: int = 0

    def inc(self, n: int = 1) -> int:
        self.value += n
        return self.value

    def merge(self, other: "Counter") -> None:
        self.value += other.value


class Histogram:
    """Streaming histogram over fixed log-spaced bins.

    Args:
      lo: values at or below ``lo`` land in the underflow bin.
      hi: values at or above ``hi`` land in the overflow bin.
      bins_per_decade: bin resolution; percentile estimates carry at most
        one bin of relative error (``10 ** (1/bins_per_decade) - 1``).

    The bin layout is part of the histogram's identity: :meth:`merge`
    refuses mismatched layouts rather than resampling (resampling would
    break merge associativity, the property that makes per-worker
    histograms roll up exactly).
    """

    def __init__(self, lo: float = 1e-9, hi: float = 1e4,
                 bins_per_decade: int = 16) -> None:
        if not (0.0 < lo < hi):
            raise ValueError("need 0 < lo < hi")
        if bins_per_decade < 1:
            raise ValueError("bins_per_decade must be >= 1")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins_per_decade = int(bins_per_decade)
        decades = math.log10(self.hi / self.lo)
        # interior bins + one underflow + one overflow
        self._n_bins = int(math.ceil(decades * self.bins_per_decade)) + 2
        self.counts = [0] * self._n_bins
        self.n = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _layout(self) -> tuple[float, float, int]:
        return (self.lo, self.hi, self.bins_per_decade)

    def _bin(self, v: float) -> int:
        if v <= self.lo:
            return 0
        if v >= self.hi:
            return self._n_bins - 1
        i = 1 + int(math.log10(v / self.lo) * self.bins_per_decade)
        return min(max(i, 1), self._n_bins - 2)

    def _bin_mid(self, i: int) -> float:
        if i <= 0:
            return self.lo
        if i >= self._n_bins - 1:
            return self.hi
        # geometric midpoint of interior bin i
        exp = (i - 0.5) / self.bins_per_decade
        return self.lo * (10.0 ** exp)

    def record(self, v: float) -> None:
        v = float(v)
        self.counts[self._bin(v)] += 1
        self.n += 1
        self.total += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else math.nan

    def percentile(self, p: float) -> float:
        """The p-th percentile estimate (p in [0, 100]); NaN when empty."""
        if not 0.0 <= p <= 100.0:
            raise ValueError("percentile must be in [0, 100]")
        if self.n == 0:
            return math.nan
        rank = max(1, math.ceil(self.n * p / 100.0))
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= rank:
                return min(max(self._bin_mid(i), self.min), self.max)
        return self.max  # unreachable: counts sum to n

    def percentiles(self, ps: Iterable[float] = (50.0, 95.0, 99.0),
                    ) -> dict[float, float]:
        return {p: self.percentile(p) for p in ps}

    def merge(self, other: "Histogram") -> None:
        if self._layout() != other._layout():
            raise ValueError(
                f"histogram layouts differ: {self._layout()} vs "
                f"{other._layout()} — merging would need resampling")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.n += other.n
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def copy(self) -> "Histogram":
        h = Histogram(self.lo, self.hi, self.bins_per_decade)
        h.merge(self)
        return h

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        if self.n == 0:
            return "Histogram(empty)"
        return (f"Histogram(n={self.n}, p50={self.percentile(50):.3g}, "
                f"p95={self.percentile(95):.3g}, "
                f"p99={self.percentile(99):.3g})")


def _key(name: str, labels: Mapping[str, Any]) -> tuple:
    return (name,) + tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Name+label-keyed counters and histograms, mergeable across workers."""

    def __init__(self) -> None:
        self._counters: dict[tuple, Counter] = {}
        self._hists: dict[tuple, Histogram] = {}

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._counters.setdefault(_key(name, labels), Counter())

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._hists.setdefault(_key(name, labels), Histogram())

    def counters(self) -> dict[tuple, int]:
        return {k: c.value for k, c in sorted(self._counters.items())}

    def histograms(self) -> dict[tuple, Histogram]:
        return dict(self._hists)

    def merge(self, other: "MetricsRegistry") -> None:
        for k, c in other._counters.items():
            self._counters.setdefault(k, Counter()).merge(c)
        for k, h in other._hists.items():
            if k in self._hists:
                self._hists[k].merge(h)
            else:
                self._hists[k] = h.copy()

    def reset(self) -> None:
        self._counters.clear()
        self._hists.clear()

    def summary(self) -> str:
        rows = ["metrics:"]
        for k, v in self.counters().items():
            name = k[0] + "".join(f" {a}={b}" for a, b in k[1:])
            rows.append(f"  {name}: {v}")
        for k, h in sorted(self._hists.items()):
            name = k[0] + "".join(f" {a}={b}" for a, b in k[1:])
            rows.append(f"  {name}: {h!r}")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# modeled-vs-measured drift
# ---------------------------------------------------------------------------

# measured span attr -> the modeled StepCost fields it is judged against
_STAGE_MODEL = {
    "hold": ("modeled_hold_s",),
    "stage": ("modeled_dac_s", "modeled_interface_s"),
    "compute": ("modeled_analog_s", "modeled_adc_s", "modeled_host_s"),
}
STAGES = ("hold", "stage", "compute", "total")


@dataclasses.dataclass(frozen=True)
class StageDrift:
    """One stage's modeled-vs-measured join across traced invocations."""

    stage: str
    modeled_s: float
    measured_s: float

    @property
    def drift(self) -> float:
        """measured / modeled; inf when unmodeled time was measured, NaN
        when the stage had neither modeled nor measured time."""
        if self.modeled_s > 0.0:
            return self.measured_s / self.modeled_s
        return math.inf if self.measured_s > 0.0 else math.nan

    @property
    def log_drift(self) -> float:
        d = self.drift
        if math.isnan(d):
            return 0.0
        if d == 0.0 or math.isinf(d):
            return math.inf
        return abs(math.log(d))


@dataclasses.dataclass
class DriftReport:
    """Per-stage modeled-vs-measured attribution over traced invocations."""

    stages: dict[str, StageDrift]
    invocations: int          # modeled invocations joined
    unmodeled: int            # invocations with no StepCost (host-like)
    per_device_s: dict[int, float] = dataclasses.field(default_factory=dict)

    @property
    def worst(self) -> StageDrift | None:
        """The worst-drifting stage (largest ``|log(drift)|``); ``total``
        is excluded — it aggregates the others and would mask which stage
        actually diverged."""
        rows = [d for s, d in self.stages.items()
                if s != "total" and not math.isnan(d.drift)]
        if not rows:
            return None
        return max(rows, key=lambda d: d.log_drift)

    def drift_for(self, stage: str) -> float:
        d = self.stages.get(stage)
        return math.nan if d is None else d.drift

    def to_json(self) -> dict:
        out: dict[str, Any] = {
            "invocations": self.invocations,
            "unmodeled": self.unmodeled,
            "stages": {s: {"modeled_s": d.modeled_s,
                           "measured_s": d.measured_s,
                           "drift": None if math.isnan(d.drift) else (
                               "inf" if math.isinf(d.drift) else d.drift)}
                       for s, d in self.stages.items()},
        }
        w = self.worst
        if w is not None:
            out["worst_stage"] = w.stage
        if self.per_device_s:
            out["per_device_stage_s"] = {str(i): v for i, v
                                         in sorted(self.per_device_s.items())}
        return out

    def table(self) -> str:
        rows = [f"drift (modeled vs measured, {self.invocations} "
                f"invocations):",
                f"  {'stage':>8}  {'modeled':>10}  {'measured':>10}  "
                f"{'drift':>7}"]
        for s in STAGES:
            d = self.stages.get(s)
            if d is None:
                continue
            drift = d.drift
            tag = "   --" if math.isnan(drift) else (
                "  inf" if math.isinf(drift) else f"{drift:7.3f}")
            rows.append(f"  {s:>8}  {d.modeled_s:10.3e}  "
                        f"{d.measured_s:10.3e}  {tag}")
        w = self.worst
        if w is not None:
            rows.append(f"  worst: {w.stage} (drift "
                        f"{'inf' if math.isinf(w.drift) else f'{w.drift:.3f}'}"
                        ")")
        if self.per_device_s:
            parts = [f"d{i}: {v:.3e}s"
                     for i, v in sorted(self.per_device_s.items())]
            rows.append("  per-device scatter staging: " + "; ".join(parts))
        return "\n".join(rows)


def drift_report(spans, category: str | None = None,
                 backend: str | None = None) -> DriftReport:
    """Join traced invocation spans against the modeled ``batched_step_cost``
    decomposition they were priced with (see module docstring for the
    stage mapping).  ``spans`` is any iterable of completed
    :class:`~repro_torch.runtime.tracing.Span` objects — typically
    ``tracer.spans()``; pass ``category``/``backend`` to restrict the join.
    Invocations served by host-like backends carry no modeled cost and are
    counted in ``unmodeled`` rather than polluting the drift ratios."""
    spans = list(spans)
    modeled = {s: 0.0 for s in STAGES}
    measured = {s: 0.0 for s in STAGES}
    n = unmodeled = 0
    per_device: dict[int, float] = {}
    inv_ids = set()
    for s in spans:
        if s.name != "invocation" or s.t1 is None:
            continue
        if category is not None and s.attrs.get("category") != category:
            continue
        if backend is not None and s.attrs.get("backend") != backend:
            continue
        inv_ids.add(s.span_id)
        if "modeled_total_s" not in s.attrs:
            unmodeled += 1
            continue
        n += 1
        for stage, fields in _STAGE_MODEL.items():
            modeled[stage] += sum(float(s.attrs.get(f, 0.0)) for f in fields)
        modeled["total"] += float(s.attrs["modeled_total_s"])
        measured["hold"] += float(s.attrs.get("hold_s", 0.0))
        measured["stage"] += float(s.attrs.get("stage_s", 0.0))
        measured["compute"] += float(s.attrs.get("compute_s", 0.0))
        measured["total"] += (float(s.attrs.get("wall_s", 0.0))
                              + float(s.attrs.get("hold_s", 0.0)))
    by_id = {s.span_id: s for s in spans}

    def _inv_ancestor(s) -> int | None:
        hops = 0
        while s.parent_id is not None and hops < 16:
            s = by_id.get(s.parent_id)
            if s is None:
                return None
            if s.name == "invocation":
                return s.span_id
            hops += 1
        return None

    for s in spans:  # per-device scatter staging under the joined invocations
        if s.name != "scatter" or s.t1 is None:
            continue
        if _inv_ancestor(s) not in inv_ids:
            continue
        d = int(s.attrs.get("device", 0))
        per_device[d] = per_device.get(d, 0.0) + s.duration_s
    stages = {s: StageDrift(s, modeled[s], measured[s]) for s in STAGES}
    return DriftReport(stages=stages, invocations=n, unmodeled=unmodeled,
                       per_device_s=per_device)
