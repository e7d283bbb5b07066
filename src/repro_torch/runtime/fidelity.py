"""Fidelity checking: pair every offloaded result with its accuracy cost.

The paper's argument cuts both ways: conversion costs time, and *skimping*
on conversion costs accuracy (fewer DAC/ADC bits -> cheaper boundary ->
worse results).  A speedup claim for the analog engine is only meaningful
next to the quantization error it introduces, so the runtime can shadow
every optical-sim batch with the host reference and report the relative
error against the bound implied by the converters' ENOB.

The bound: a b-bit uniform quantizer on a full-scale signal contributes
RMS error ~ q / sqrt(12) with q = 1 / (2^b - 1), i.e. a relative L2 error
on the order of 2^-b (see :func:`repro_torch.core.conversion.enob_error_bound`,
shared with the planner's fidelity gate).  The optical pipeline squares the
field at the detector (intensity doubles relative error) and auto-ranges
the ADC, so we allow a configurable slack factor over the ideal-quantizer
floor; what the checker *guarantees* is the paper-relevant direction:
error decreases as converter resolution increases, and a result that blows
through the bound flags a broken offload rather than silently serving
garbage.

Scoring is vectorized: the whole batch reduces to per-frame L2 norms in
ONE batched device computation and ONE host sync (a per-frame ``float()``
loop would pay a blocking device round-trip per frame — K syncs for a
K-deep batch on the hot path).  ``sample_every`` bounds the shadowing cost
further: only every Nth batch per category is scored (the skipped batches
also keep the executor's async pipeline, since shadow scoring is the part
that forces synchronous retirement).
"""

from __future__ import annotations

import collections
import dataclasses

import torch

from repro_torch.core.conversion import enob_error_bound

__all__ = ["FidelityReport", "FidelityChecker", "enob_error_bound"]


@dataclasses.dataclass(frozen=True)
class FidelityReport:
    category: str
    backend: str
    batch: int
    rel_err: float          # max over the batch of ||got-ref|| / ||ref||
    enob: float             # limiting converter ENOB used for the bound
    bound: float

    @property
    def ok(self) -> bool:
        return self.rel_err <= self.bound

    def __str__(self) -> str:
        flag = "ok" if self.ok else "VIOLATION"
        return (f"fidelity[{self.category}/{self.backend} x{self.batch}] "
                f"rel_err={self.rel_err:.3e} bound={self.bound:.3e} "
                f"(enob={self.enob:.1f}) {flag}")


def _batch_rel_err(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Worst per-frame relative L2 error over a ``(K, n)`` stacked batch —
    one reduction, one scalar out (the caller's ``float()`` is the only
    device sync for the whole batch).

    Zero-norm reference frames are well-defined rather than
    denominator-clamped garbage: a zero reference reproduced exactly scores
    0; any nonzero output against a zero reference scores ``inf`` (the
    offload fabricated signal out of nothing — always a violation for any
    finite bound)."""
    err = torch.linalg.vector_norm(got - ref, dim=1)
    refn = torch.linalg.vector_norm(ref, dim=1)
    inf = torch.full_like(err, float("inf"))
    rel = torch.where(refn > 0.0,
                      err / torch.where(refn > 0.0, refn,
                                        torch.ones_like(refn)),
                      torch.where(err > 0.0, inf, torch.zeros_like(err)))
    return torch.amax(rel)


class FidelityChecker:
    """Accumulates per-batch quantization-error reports.

    ``slack`` widens the ideal-quantizer floor to cover detector squaring,
    ADC auto-ranging, and error accumulation across the DFT; tune it down
    to make the checker stricter.

    ``sample_every=N`` scores only every Nth shadowed batch per category
    (the executor consults :meth:`should_check` before paying the shadow
    reference run), bounding validation overhead on hot paths; 1 (default)
    scores everything.
    """

    def __init__(self, slack: float = 16.0, sample_every: int = 1) -> None:
        if sample_every < 1:
            raise ValueError("sample_every must be >= 1")
        self.slack = slack
        self.sample_every = sample_every
        self.reports: list[FidelityReport] = []
        self._seen: collections.Counter[str] = collections.Counter()

    def should_check(self, category: str) -> bool:
        """Sampling decision for the next shadowed batch of ``category``
        (consumes one tick of the per-category ``sample_every`` cycle; the
        first batch of every category is always scored)."""
        n = self._seen[category]
        self._seen[category] += 1
        return n % self.sample_every == 0

    def check(self, category: str, backend: str, got: list[torch.Tensor],
              ref: list[torch.Tensor], *, enob: float) -> FidelityReport:
        g = torch.stack([torch.as_tensor(x).to(torch.float32).reshape(-1)
                         for x in got])
        r = torch.stack([torch.as_tensor(x).to(torch.float32).reshape(-1)
                         for x in ref]).to(g.device)
        rel = float(_batch_rel_err(g, r))
        report = FidelityReport(category=category, backend=backend,
                                batch=len(got), rel_err=rel, enob=enob,
                                bound=enob_error_bound(enob, self.slack))
        self.reports.append(report)
        return report

    # -- rollups ---------------------------------------------------------------
    def violations(self, category: str | None = None) -> list[FidelityReport]:
        """Reports whose relative error blew through the ENOB bound — the
        drifted/mis-ranged batches.  The executor's drift-correction path
        quarantines on these; operators read them to see what drifted."""
        return [r for r in self.reports
                if not r.ok and (category is None or r.category == category)]

    def worst(self, category: str | None = None) -> FidelityReport | None:
        pool = [r for r in self.reports
                if category is None or r.category == category]
        return max(pool, key=lambda r: r.rel_err) if pool else None

    @property
    def all_ok(self) -> bool:
        return all(r.ok for r in self.reports)

    def summary(self) -> str:
        if not self.reports:
            return "fidelity: no checks recorded"
        lines = [str(r) for r in self.reports[-8:]]
        w = self.worst()
        lines.append(f"fidelity worst: {w.category} rel_err={w.rel_err:.3e} "
                     f"({'within' if self.all_ok else 'OUTSIDE'} ENOB budget)")
        return "\n".join(lines)
