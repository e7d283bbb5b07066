"""Admission-controlled continuous batching: who decides when a boundary
crossing happens.

The paper's occupancy argument (and the serving literature's continuous-
batching one) says the conversion boundary only amortizes when every
crossing carries a full batch — but the pre-scheduler runtime drained the
whole queue on every flush, so trickle traffic crossed the boundary one
frame at a time and paid the full per-invocation handshake, settle, and
lane-ceil residue each time.  :class:`OffloadScheduler` closes that gap by
owning the *admission and release* decisions the executor used to make
implicitly:

* submissions accumulate in the executor's queue as usual, but a partially
  filled group may be **held open across flushes** — the scheduler releases
  it only when one of three things is true:

  (a) **full**: the group reached its ``max_batch`` ceiling — waiting
      cannot raise occupancy further, dispatch the full chunks now;
  (b) **due**: the oldest held call's age reached the group's deadline —
      the latency budget is spent, dispatch whatever occupancy was won;
  (c) **futile**: the telemetry-estimated arrival rate
      (:meth:`RuntimeTelemetry.arrival_rate`, from submit timestamps) says
      the *next* arrival is expected after the deadline — holding longer
      buys latency without buying occupancy, so dispatch immediately.

  Until two arrivals have been observed there is no rate estimate and the
  scheduler holds optimistically (rule (b) still bounds the wait).

* released groups dispatch through the executor's existing mechanisms —
  :meth:`OffloadExecutor.release` feeds the same batched, double-buffered,
  optionally sharded pipeline — and the time a group spent held is priced
  into its invocation (``StepCost.hold_s``), so the modeled wall honestly
  charges the queueing delay that bought the occupancy.  At low arrival
  rates this is exactly the regime that feeds the sharded fleet: a held
  group deep enough to scatter across ``n_devices`` apertures, where
  drain-on-flush would have sent ``n`` lonely frames through one device's
  converters serially.

The executor's ``flush``/``flush_async``/``drain``/``get`` remain the
force-release path (they dispatch held work immediately); the scheduler is
the *pacing* path — call :meth:`poll` from an event loop, a serving
engine's decode step, or after each submit (``submit`` polls for you).

Deterministic by construction: every time read goes through the injected
``clock``, so tests and benchmarks drive admission with a
:class:`ManualClock` instead of sleeping.
"""

from __future__ import annotations

import math
from typing import Callable, Mapping

import torch

from repro_torch.runtime.executor import OffloadExecutor, OffloadResult

__all__ = ["ManualClock", "OffloadScheduler"]


class ManualClock:
    """A callable clock tests and benchmarks advance by hand, so admission
    decisions (ages, arrival rates, deadlines) are deterministic instead of
    wall-clock-raced."""

    def __init__(self, t: float = 0.0) -> None:
        self.t = float(t)

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("time does not run backwards")
        self.t += dt
        return self.t

    def __call__(self) -> float:
        return self.t


class OffloadScheduler:
    """Arrival-aware admission control over an :class:`OffloadExecutor`.

    Args:
      target: the executor to pace — or a ``PlanRouter`` (anything with an
        ``.executor`` and a routing ``submit``); submissions then follow
        the router's category->backend table while the scheduler paces
        their release.
      deadline_s: default per-category queueing-delay budget: no call is
        held longer than this before its group dispatches.
      deadlines: optional ``{category: deadline_s}`` overrides.
      clock: timebase for admission decisions; defaults to the executor's
        own clock so submit timestamps and poll times agree.

    The scheduler registers itself with the executor
    (``attach_scheduler``), which flips the executor into held-queue
    semantics: ``drain`` releases held groups, dispatch prices hold time,
    and eager ``flush`` becomes the force-release escape hatch.
    """

    def __init__(self, target, *,
                 deadline_s: float = 0.05,
                 deadlines: Mapping[str, float] | None = None,
                 clock: Callable[[], float] | None = None) -> None:
        if deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
        self.executor: OffloadExecutor = getattr(target, "executor", target)
        self._submitter = target
        self.deadline_s = deadline_s
        self._deadlines = dict(deadlines or {})
        self._clock = clock or self.executor._clock
        self.executor.attach_scheduler(self)

    # -- configuration ---------------------------------------------------------
    def deadline_for(self, category: str) -> float:
        return self._deadlines.get(category, self.deadline_s)

    def set_deadline(self, category: str, deadline_s: float) -> None:
        if deadline_s < 0:
            raise ValueError("deadline_s must be >= 0")
        self._deadlines[category] = deadline_s

    # -- the client API --------------------------------------------------------
    def submit(self, category: str, x: torch.Tensor, **kwargs) -> OffloadResult:
        """Queue one call (through the router's table when one was given)
        and run an admission pass: a group that just hit ``max_batch``
        dispatches on the spot — continuous batching without an external
        pump."""
        result = self._submitter.submit(category, x, **kwargs)
        self.poll()
        return result

    def poll(self, now: float | None = None) -> list[OffloadResult]:
        """One admission pass over the held queue: release every group that
        is full, due, or futile to keep holding (see the module docstring
        for the three rules); hold the rest.  Returns the handles released
        by this pass (already dispatched through the async pipeline)."""
        if now is None:
            now = self._clock()
        telemetry = self.executor.telemetry
        released: list[OffloadResult] = []
        for key, members in self.executor.pending_groups().items():
            category = members[0].category
            cap = self.executor.max_batch_for(category)
            # (a) full: dispatch complete chunks, keep the tail held
            full = (len(members) // cap) * cap
            if full:
                released.extend(self.executor.release(key, full,
                                                      reason="full"))
                members = members[full:]
                if not members:
                    continue
            deadline = self.deadline_for(category)
            age = now - members[0].t_submit
            rate = telemetry.arrival_rate(category)
            due = age >= deadline
            # (c) expected next arrival lands past the deadline: holding
            # buys latency but no occupancy (rate inf => next arrival is
            # immediate => keep holding; rate 0 => no estimate yet =>
            # hold until the deadline decides)
            futile = (0.0 < rate < math.inf) and (age + 1.0 / rate > deadline)
            if due or futile:
                released.extend(self.executor.release(
                    key, reason="due" if due else "futile"))
        return released

    def release_all(self) -> list[OffloadResult]:
        """Force-release every held group (deadline and rate ignored)."""
        return self.executor.flush_async()

    def flush(self) -> list[OffloadResult]:
        """Force-release everything and drain the pipeline (blocking) —
        the scheduler-aware equivalent of ``executor.flush()``."""
        return self.executor.flush()

    def drain(self) -> None:
        """Release held groups and retire all in-flight invocations."""
        self.executor.drain()

    # -- introspection ---------------------------------------------------------
    @property
    def pending(self) -> int:
        """Queued calls, held or not (the serving engine's aux gauge)."""
        return self.executor.pending

    @property
    def held(self) -> int:
        """Calls currently held awaiting admission (== queued calls: with a
        scheduler attached the queue *is* the hold buffer)."""
        return self.executor.pending

    def held_groups(self) -> list[dict]:
        """Diagnostics: one row per held group — category, depth, oldest
        age, the deadline it is counting down, and the current arrival-rate
        estimate feeding rule (c)."""
        now = self._clock()
        telemetry = self.executor.telemetry
        rows = []
        for members in self.executor.pending_groups().values():
            category = members[0].category
            rows.append({
                "category": category,
                "held": len(members),
                "max_batch": self.executor.max_batch_for(category),
                "oldest_age_s": now - members[0].t_submit,
                "deadline_s": self.deadline_for(category),
                "arrival_rate_hz": telemetry.arrival_rate(category),
            })
        return rows

    def __enter__(self) -> "OffloadScheduler":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # held + in-flight groups drain even when the body raised (and a
        # drain error never masks the body's exception)
        self.executor.close(unwinding=exc_type is not None)
        return False

    def summary(self) -> str:
        rows = [f"scheduler: deadline={self.deadline_s * 1e3:.1f}ms "
                f"held={self.held}"]
        for g in self.held_groups():
            rows.append(
                f"  {g['category']:>8}: held={g['held']}/{g['max_batch']} "
                f"age={g['oldest_age_s'] * 1e3:.1f}ms "
                f"deadline={g['deadline_s'] * 1e3:.1f}ms "
                f"rate={g['arrival_rate_hz']:.3g}/s")
        return "\n".join(rows)
