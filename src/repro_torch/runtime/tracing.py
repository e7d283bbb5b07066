"""Boundary-attributed span tracing: where did a flush's wall time go?

The paper's whole argument is an *attribution* claim — the DAC/ADC
conversion boundary, not the analog core, bounds end-to-end speedup — yet
``RuntimeTelemetry`` only accumulates per-(category, backend) totals.  This
module adds the missing axis: one span tree per batched invocation, so a
single flush decomposes into

    submit -> held(reason) -> release(full|due|futile) -> tile[t]
           -> stage (host staging + DAC-prep + dispatch)
           -> compute (in-flight analog propagation + ADC/readout)
           -> fidelity-shadow

with sharded dispatch additionally emitting one ``scatter`` child span per
device, so host-side scatter/gather staging — the ROADMAP's suspect for the
sharded wall regression — is finally visible rather than inferred.

Fault handling (``repro_torch.runtime.faults``) adds its own span vocabulary on
the ``sched`` and per-device lanes: ``fault`` instants (kind = error /
straggle / drift / device_loss), ``retry`` spans covering each backoff
window, ``fallback`` instants marking graceful degradation to the host
backend, and ``quarantine`` spans covering a device's or category's
exclusion window.  The operand residency cache
(``repro_torch.runtime.residency``) emits ``cache`` instants on the host lane
(kind = hit / miss / eviction / invalidation, with the operand category
and byte count), so every boundary crossing the cache *avoided* is as
visible as the ones that were paid.  None of these carry charged time —
the reconcile / drift contract reads only ``invocation`` trees — so
fault and cache observability can never unbalance the wall accounting.

Design constraints (all load-bearing):

* **Zero dependencies, zero default overhead.**  Tracing is opt-in
  (``OffloadExecutor(tracer=...)``); every instrumentation site guards on
  ``tracer is not None``, so the default path adds nothing but an
  attribute read.
* **Injectable clock.**  ``Tracer(clock=ManualClock())`` shares the
  executor's manual timebase, so tests assert span durations *exactly*
  (a group held 30 ms under a ManualClock yields a held span of exactly
  0.030 s).  The default is ``time.perf_counter`` — the same timebase the
  executor's wall accounting uses.
* **Thread-safe ring buffer.**  Spans land in a bounded ``deque``
  (``capacity`` completed spans; the oldest drop and ``dropped`` counts
  them), guarded by a lock, so a long-running serving loop can leave the
  tracer attached without unbounded growth.
* **Charged-time semantics.**  Leaf ``stage``/``compute`` spans mirror the
  executor's retirement accounting (charge from where the previous
  retirement ended, never bill pipeline overlap twice), so per-stage sums
  reconcile with the measured flush wall — the invariant the bench gate
  and the Perfetto export both rely on.

Consumers: :mod:`repro_torch.runtime.trace_export` (Chrome/Perfetto
``trace_event`` JSON), :func:`repro_torch.runtime.metrics.drift_report`
(modeled-vs-measured per stage), and the trace summary printed by
``examples/optical_offload.py``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Iterator

from repro_torch.runtime.metrics import MetricsRegistry

__all__ = ["Span", "Tracer"]


@dataclasses.dataclass
class Span:
    """One timed interval on a lane of the runtime.

    ``kind`` distinguishes rendering semantics:
      ``sync``     a lexically scoped duration (Perfetto "complete" slice);
                   sync spans on one lane either nest or do not overlap.
      ``async``    a container that outlives its dispatch scope (release,
                   invocation, held) — may overlap other containers on the
                   same lane, exported as async begin/end events.
      ``instant``  a point event (submit).
    """

    name: str
    span_id: int
    trace_id: int
    parent_id: int | None
    lane: str
    kind: str = "sync"
    t0: float = 0.0
    t1: float | None = None
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def annotate(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self


class Tracer:
    """Thread-safe span recorder with an injectable clock.

    Args:
      clock: timebase for span timestamps.  Pass the executor's
        ``ManualClock`` for exact assertions; the default
        ``time.perf_counter`` matches the executor's wall accounting.
      capacity: completed spans retained (ring buffer); the oldest are
        dropped beyond it and counted in :attr:`dropped`.

    Spans parent two ways: explicitly (``parent=``) or lexically — the
    :meth:`span` context manager keeps a per-thread active-span stack, so
    a backend that opens spans inside an instrumented dispatch nests under
    the invocation without the executor threading handles through every
    call signature.  :attr:`metrics` is a :class:`MetricsRegistry` the
    instrumented runtime feeds alongside spans (release-reason counters,
    span-latency histograms).
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 capacity: int = 65536) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._clock = clock
        self.capacity = capacity
        self._lock = threading.Lock()
        self._done: collections.deque[Span] = collections.deque()
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self.dropped = 0
        self.metrics = MetricsRegistry()

    # -- timebase --------------------------------------------------------------
    def now(self) -> float:
        return self._clock()

    # -- the active-span stack (per thread) ------------------------------------
    def _stack(self) -> list[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> Span | None:
        """The innermost lexically active span on this thread (if any)."""
        st = self._stack()
        return st[-1] if st else None

    # -- span creation ---------------------------------------------------------
    def _new(self, name: str, lane: str, kind: str, t0: float,
             parent: "Span | int | None", attrs: dict[str, Any]) -> Span:
        if isinstance(parent, Span):
            pid, tid = parent.span_id, parent.trace_id
        elif parent is not None:
            pid, tid = int(parent), None
        else:
            active = self.current()
            pid = active.span_id if active is not None else None
            tid = active.trace_id if active is not None else None
        with self._lock:
            sid = next(self._ids)
        if tid is None:
            tid = sid if pid is None else pid
        return Span(name=name, span_id=sid, trace_id=tid, parent_id=pid,
                    lane=lane, kind=kind, t0=t0, attrs=dict(attrs))

    def _finish(self, span: Span) -> Span:
        with self._lock:
            if len(self._done) >= self.capacity:
                self._done.popleft()
                self.dropped += 1
            self._done.append(span)
        return span

    def begin(self, name: str, *, lane: str = "host", kind: str = "async",
              parent: "Span | int | None" = None, **attrs: Any) -> Span:
        """Open a non-lexical span (ends later via :meth:`end` — the
        dispatch->retire pattern).  Not pushed on the lexical stack."""
        return self._new(name, lane, kind, self.now(), parent, attrs)

    def end(self, span: Span, t1: float | None = None) -> Span:
        """Close a span opened with :meth:`begin` and commit it."""
        span.t1 = self.now() if t1 is None else t1
        if span.t1 < span.t0:  # a clock respecting causality only
            span.t1 = span.t0
        return self._finish(span)

    @contextlib.contextmanager
    def span(self, name: str, *, lane: str = "host", kind: str = "sync",
             parent: "Span | int | None" = None,
             **attrs: Any) -> Iterator[Span]:
        """Lexically scoped span; children opened inside nest under it."""
        s = self._new(name, lane, kind, self.now(), parent, attrs)
        st = self._stack()
        st.append(s)
        try:
            yield s
        finally:
            st.pop()
            self.end(s)

    def instant(self, name: str, *, lane: str = "host",
                parent: "Span | int | None" = None, **attrs: Any) -> Span:
        """A point event (t0 == t1)."""
        t = self.now()
        s = self._new(name, lane, "instant", t, parent, attrs)
        s.t1 = t
        return self._finish(s)

    def record(self, name: str, t0: float, t1: float, *, lane: str = "host",
               kind: str = "sync", parent: "Span | int | None" = None,
               **attrs: Any) -> Span:
        """Commit a retrospective span whose window is already known (the
        executor learns an invocation's charged compute window only at
        retirement)."""
        s = self._new(name, lane, kind, t0, parent, attrs)
        s.t1 = max(t1, t0)
        return self._finish(s)

    # -- views -----------------------------------------------------------------
    def spans(self) -> list[Span]:
        """Snapshot of completed spans in completion order."""
        with self._lock:
            return list(self._done)

    def find(self, name: str | None = None,
             lane: str | None = None) -> list[Span]:
        return [s for s in self.spans()
                if (name is None or s.name == name)
                and (lane is None or s.lane == lane)]

    def children(self, parent: Span) -> list[Span]:
        return [s for s in self.spans() if s.parent_id == parent.span_id]

    def clear(self) -> None:
        with self._lock:
            self._done.clear()
            self.dropped = 0
