"""Fault handling for the offload boundary (the executor-facing half).

Real analog hardware makes the conversion boundary *unreliable*, not just
expensive: converters drift out of their ENOB budget, apertures mis-range,
links drop dispatches, devices stall or disappear.  This module holds the
pieces :class:`~repro_torch.runtime.executor.OffloadExecutor` threads
through every dispatch:

  :class:`FaultError`        the handleable fault hierarchy
                             (:class:`TransientDispatchError`): anything
                             else a
                             backend raises is a programming error and
                             propagates.
  :class:`RetryPolicy`       per-dispatch fault policy: max attempts,
                             exponential backoff with seeded jitter (slept
                             through the injected clock), the fallback
                             backend for graceful degradation, and the
                             straggler-deadline / quarantine-window knobs.
  :class:`DispatchWatchdog`  keyed :class:`TrailingMedianDeadline`
                             detectors: a dispatch whose wall exceeds
                             ``factor x max(trailing median, modeled
                             batched_step_cost wall, floor)`` is a
                             straggler.
  :class:`Quarantine`        time-windowed exclusion of failing devices
                             (``("device", d)``) and categories
                             (``("category", cat)``): quarantined keys are
                             rerouted to the fallback backend; after the
                             window a *probation* period follows —
                             re-offending on probation doubles the next
                             window, staying clean resets it.

The injection half of the reference (``ChaosBackend``, ``FaultSchedule``,
``register_chaos``, ``DeviceLostError``) is not ported yet.  ``RetryPolicy`` keeps
``random.Random(seed)`` so its jitter stream equals the reference's.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable

from repro_torch.distributed.straggler import TrailingMedianDeadline

__all__ = [
    "FaultError",
    "TransientDispatchError",
    "RetryPolicy",
    "DispatchWatchdog",
    "QuarantineEvent",
    "Quarantine",
    "advance_or_sleep",
]


class FaultError(RuntimeError):
    """Base of every injectable/handleable dispatch fault.

    The executor's retry policy catches exactly this hierarchy: anything
    else a backend raises is a programming error and propagates."""

    kind = "fault"


class TransientDispatchError(FaultError):
    """A dispatch that failed before producing results (dropped handshake,
    failed launch) — retryable on the same backend."""

    kind = "error"


def advance_or_sleep(clock: Callable[[], float] | None, dt_s: float) -> None:
    """Let ``dt_s`` pass on whatever timebase the runtime runs on: a
    ``ManualClock`` is advanced (deterministic tests/benches — no real
    sleeping), anything else costs a real ``time.sleep``."""
    if dt_s <= 0.0:
        return
    adv = getattr(clock, "advance", None)
    if adv is not None:
        adv(dt_s)
    else:
        time.sleep(dt_s)


@dataclasses.dataclass
class RetryPolicy:
    """Per-dispatch fault policy the executor runs every invocation under.

    A dispatch that raises :class:`FaultError` is retried on the same
    backend up to ``max_attempts`` total attempts, sleeping an
    exponentially growing, jittered backoff between attempts (through the
    injected clock — a ManualClock makes the whole sequence
    deterministic).  When every attempt faults, the dispatch **degrades
    gracefully**: it re-runs on ``fallback`` (the host backend — always
    correct, never faulted) and the category is quarantined for
    ``quarantine_s`` so subsequent dispatches reroute immediately instead
    of re-paying the retry ladder.

    The straggler knobs configure the :class:`DispatchWatchdog` deadline
    (``factor x max(trailing median, modeled wall, floor)``) and the
    per-device quarantine patience used by sharded dispatch.
    """

    max_attempts: int = 3
    backoff_s: float = 1e-3          # first backoff
    backoff_factor: float = 2.0      # growth per attempt
    jitter: float = 0.5              # uniform [0, jitter] multiplier on top
    seed: int = 0                    # jitter stream seed
    fallback: str = "host"
    straggler_factor: float = 3.0
    straggler_window: int = 32
    straggler_floor_s: float = 0.05
    straggler_patience: int = 3
    quarantine_s: float = 0.25
    probation_s: float = 0.25

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_s < 0.0 or self.backoff_factor < 1.0:
            raise ValueError("backoff_s >= 0 and backoff_factor >= 1 required")
        if self.jitter < 0.0:
            raise ValueError("jitter must be >= 0")
        self._rng = random.Random(self.seed)

    def backoff_for(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based), jittered so
        concurrent retriers do not re-collide in lockstep."""
        base = self.backoff_s * self.backoff_factor ** (attempt - 1)
        return base * (1.0 + self.jitter * self._rng.random())


class DispatchWatchdog:
    """Keyed straggler detectors over dispatch wall times.

    One :class:`TrailingMedianDeadline` per key — the executor keys by
    ``(category, backend)``, the sharded backend by ``("device", name,
    d)`` — so one traffic class's healthy baseline never judges another's.
    """

    def __init__(self, *, factor: float = 3.0, window: int = 32,
                 floor_s: float = 0.05, patience: int = 3) -> None:
        self.factor = factor
        self.window = window
        self.floor_s = floor_s
        self.patience = patience
        self._detectors: dict = {}

    def _detector(self, key) -> TrailingMedianDeadline:
        det = self._detectors.get(key)
        if det is None:
            det = self._detectors[key] = TrailingMedianDeadline(
                factor=self.factor, window=self.window,
                floor_s=self.floor_s, patience=self.patience)
        return det

    def deadline_s(self, key, base_s: float | None = None) -> float:
        return self._detector(key).deadline_s(base_s)

    def observe(self, key, dt_s: float, base_s: float | None = None) -> bool:
        """Score one dispatch wall time; True means straggler."""
        return self._detector(key).observe(dt_s, base_s)


@dataclasses.dataclass(frozen=True)
class QuarantineEvent:
    """One quarantine decision, for observability and tests."""

    key: tuple
    reason: str
    t: float
    until: float
    probation_until: float
    level: int


class Quarantine:
    """Time-windowed exclusion of failing devices and categories.

    Lifecycle of a key (``("device", d)`` or ``("category", cat)``):

      healthy -> quarantined (``window_s * 2**level``) -> **probation**
      (``probation_s``) -> healthy

    Re-offending *during probation* escalates ``level`` (doubling the
    next window); surviving probation clean resets it.  Straggler strikes
    accumulate per key via :meth:`note_straggle` and quarantine after
    ``patience`` consecutive ones; :meth:`note_healthy` forgives the
    streak.  All time comes from the caller's clock, so the whole
    lifecycle is deterministic under a ManualClock.
    """

    def __init__(self, *, window_s: float = 0.25,
                 probation_s: float = 0.25, patience: int = 3) -> None:
        if window_s <= 0.0 or probation_s < 0.0:
            raise ValueError("window_s > 0 and probation_s >= 0 required")
        if patience < 1:
            raise ValueError("patience must be >= 1")
        self.window_s = float(window_s)
        self.probation_s = float(probation_s)
        self.patience = int(patience)
        self.events: list[QuarantineEvent] = []
        self._until: dict[tuple, float] = {}
        self._probation_until: dict[tuple, float] = {}
        self._level: dict[tuple, int] = {}
        self._strikes: dict[tuple, int] = {}

    def is_quarantined(self, key: tuple, now: float) -> bool:
        return now < self._until.get(key, float("-inf"))

    def on_probation(self, key: tuple, now: float) -> bool:
        return (not self.is_quarantined(key, now)
                and now < self._probation_until.get(key, float("-inf")))

    def until(self, key: tuple) -> float | None:
        """End of ``key``'s latest quarantine window (None if never)."""
        return self._until.get(key)

    def quarantine(self, key: tuple, now: float,
                   reason: str = "fault") -> QuarantineEvent:
        """Exclude ``key`` starting ``now``; returns the decision.

        A key quarantined while on probation is a repeat offender: its
        window doubles.  A key whose probation expired cleanly starts over
        at the base window.
        """
        level = self._level.get(key, 0) + 1 if self.on_probation(key, now) \
            else 0
        until = now + self.window_s * (2 ** level)
        self._until[key] = until
        self._probation_until[key] = until + self.probation_s
        self._level[key] = level
        self._strikes[key] = 0
        ev = QuarantineEvent(key=key, reason=reason, t=now, until=until,
                             probation_until=until + self.probation_s,
                             level=level)
        self.events.append(ev)
        return ev

    def note_straggle(self, key: tuple, now: float) -> QuarantineEvent | None:
        """One straggler strike against ``key``; quarantines (and returns
        the event) when the streak reaches ``patience``."""
        if self.is_quarantined(key, now):
            return None
        strikes = self._strikes.get(key, 0) + 1
        if strikes >= self.patience:
            return self.quarantine(key, now, reason="straggler")
        self._strikes[key] = strikes
        return None

    def note_healthy(self, key: tuple) -> None:
        """A healthy observation forgives the straggler streak."""
        self._strikes[key] = 0

    def active(self, now: float) -> tuple[tuple, ...]:
        """Keys currently quarantined, sorted."""
        return tuple(sorted(k for k, t in self._until.items() if now < t))

    def active_device_count(self, now: float) -> int:
        """How many logical devices are currently quarantined (the router
        shrinks the sharded fan-out by this)."""
        return sum(1 for k in self.active(now) if k and k[0] == "device")

    def summary(self, now: float) -> str:
        act = self.active(now)
        rows = [f"quarantine: {len(act)} active, "
                f"{len(self.events)} events"]
        for k in act:
            rows.append(f"  {k}: until={self._until[k]:.3f}s "
                        f"level={self._level.get(k, 0)}")
        return "\n".join(rows)
