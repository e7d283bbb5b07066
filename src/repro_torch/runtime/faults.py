"""Fault injection + fault handling for the offload boundary.

Real analog hardware makes the conversion boundary *unreliable*, not just
expensive: converters drift out of their ENOB budget, apertures mis-range,
links drop dispatches, devices stall or disappear.  This module gives the
runtime both halves of that story:

**Injection** — :class:`ChaosBackend` wraps any registered backend and
perturbs its dispatches according to a deterministic, seeded
:class:`FaultSchedule`:

  ``error``        the dispatch raises :class:`TransientDispatchError`
                   before touching the inner backend (a dropped link
                   handshake / failed launch).
  ``straggle``     the dispatch completes but takes ``straggle_s`` longer
                   (a slow host, a congested link) — injected through the
                   executor's clock (``ManualClock.advance`` in tests, a
                   real ``time.sleep`` otherwise), so straggler detection
                   is exactly as deterministic as the clock.
  ``drift``        the inner result is scaled by ``drift_gain`` on the
                   result's own device (a DAC mis-range / detector
                   drift): numerically wrong in a way only the
                   :class:`~repro_torch.runtime.fidelity.FidelityChecker`
                   shadow can catch.
  ``device_loss``  under sharded dispatch (``ctx.n_devices > 1``) one
                   logical device is marked lost via ``ctx.lost_devices``
                   and the sharded backend's shard on it raises
                   :class:`DeviceLostError` mid-scatter; unsharded, the
                   whole dispatch raises it.

**Handling** — the pieces
:class:`~repro_torch.runtime.executor.OffloadExecutor` and
:class:`~repro_torch.runtime.sharded.ShardedOpticalBackend` thread through
every dispatch:

  :class:`RetryPolicy`       per-dispatch fault policy: max attempts,
                             exponential backoff with seeded jitter (slept
                             through the injected clock), the fallback
                             backend for graceful degradation, and the
                             straggler-deadline / quarantine-window knobs.
  :class:`DispatchWatchdog`  keyed :class:`TrailingMedianDeadline`
                             detectors (shared with the training runner's
                             fault story): a dispatch whose wall exceeds
                             ``factor x max(trailing median, modeled
                             batched_step_cost wall, floor)`` is a
                             straggler.
  :class:`Quarantine`        time-windowed exclusion of failing devices
                             (``("device", d)``) and categories
                             (``("category", cat)``): quarantined keys are
                             skipped by sharded scatter / rerouted to the
                             fallback backend; after the window a
                             *probation* period follows — re-offending on
                             probation doubles the next window, staying
                             clean resets it.

The equivalence invariant under faults: every submitted frame retires, in
submit order, with results equal to the fault-free run of the same backend
(bit-for-bit on digital backends; frames served by the host fallback are
bit-equal to the looped host baseline).  Faults change *when and where* a
frame executes, never *what* it returns.

Schedules draw from ``random.Random(seed)``, as the reference's do, so a
seed gives the same fault sequence in both packages, fault by fault;
``RetryPolicy``'s jitter stream is the reference's for the same reason.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Mapping, Sequence

from repro_torch.distributed.straggler import TrailingMedianDeadline
from repro_torch.runtime.backends import (
    BackendContext,
    ExecutionBackend,
    get_backend,
    register_backend,
)

__all__ = [
    "Fault",
    "FaultError",
    "TransientDispatchError",
    "DeviceLostError",
    "FaultSchedule",
    "ChaosBackend",
    "register_chaos",
    "RetryPolicy",
    "DispatchWatchdog",
    "QuarantineEvent",
    "Quarantine",
    "advance_or_sleep",
]

FAULT_KINDS = ("error", "straggle", "drift", "device_loss")


class FaultError(RuntimeError):
    """Base of every injectable/handleable dispatch fault.

    The executor's retry policy catches exactly this hierarchy: anything
    else a backend raises is a programming error and propagates."""

    kind = "fault"


class TransientDispatchError(FaultError):
    """A dispatch that failed before producing results (dropped handshake,
    failed launch) — retryable on the same backend."""

    kind = "error"


class DeviceLostError(FaultError):
    """A (logical) device disappeared mid-dispatch."""

    kind = "device_loss"

    def __init__(self, device: int, msg: str | None = None) -> None:
        super().__init__(msg or f"device {device} lost mid-dispatch")
        self.device = int(device)


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


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault: what goes wrong with one dispatch."""

    kind: str                # one of FAULT_KINDS
    delay_s: float = 0.0     # straggle: extra dispatch latency
    gain: float = 1.0        # drift: multiplicative result corruption
    device: int = 0          # device_loss: which logical device drops

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")


class FaultSchedule:
    """Deterministic per-dispatch fault sequence.

    Two authoring modes, composable:

    * **seeded rate**: each dispatch draws from a ``random.Random(seed)``
      stream; with probability ``rate`` it gets a fault of a uniformly
      chosen kind from ``kinds``.  The draw sequence depends only on
      ``(seed, dispatch index)``, so two identical runs fault identically.
    * **scripted**: ``script={dispatch_index: Fault(...)}`` pins exact
      faults to exact dispatches (the unit-test mode); scripted entries
      take precedence over the rate draw at their index.

    Schedules are stateful (they count dispatches); :meth:`fresh` returns
    an unconsumed copy with the same parameters — the registration helper
    hands every backend instantiation its own copy, so executors never
    share (and therefore never race on) a draw stream.
    """

    def __init__(self, rate: float = 0.0, *, seed: int = 0,
                 kinds: Sequence[str] = FAULT_KINDS,
                 straggle_s: float = 0.25, drift_gain: float = 8.0,
                 script: Mapping[int, Fault] | None = None) -> None:
        if not 0.0 <= rate <= 1.0:
            raise ValueError("rate must be in [0, 1]")
        for k in kinds:
            if k not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {k!r}")
        self.rate = float(rate)
        self.seed = int(seed)
        self.kinds = tuple(kinds)
        self.straggle_s = float(straggle_s)
        self.drift_gain = float(drift_gain)
        self.script = dict(script or {})
        self.index = 0          # dispatches drawn so far
        self.injected = 0       # faults actually handed out
        self._rng = random.Random(self.seed)

    def fresh(self) -> "FaultSchedule":
        """An unconsumed copy: same parameters, rewound draw stream."""
        return FaultSchedule(self.rate, seed=self.seed, kinds=self.kinds,
                             straggle_s=self.straggle_s,
                             drift_gain=self.drift_gain, script=self.script)

    def draw(self) -> Fault | None:
        """The fault (or None) for the next dispatch."""
        i = self.index
        self.index += 1
        # the rate draw happens unconditionally so scripted entries do not
        # shift the stream for later indices
        hit = self.rate > 0.0 and self._rng.random() < self.rate
        if i in self.script:
            self.injected += 1
            return self.script[i]
        if not hit or not self.kinds:
            return None
        kind = self._rng.choice(self.kinds)
        self.injected += 1
        if kind == "straggle":
            return Fault("straggle", delay_s=self.straggle_s)
        if kind == "drift":
            return Fault("drift", gain=self.drift_gain)
        if kind == "device_loss":
            return Fault("device_loss", device=self._rng.randrange(1 << 16))
        return Fault("error")


class ChaosBackend(ExecutionBackend):
    """Any registered backend, with a :class:`FaultSchedule` between the
    executor and it.

    Transparent when the schedule draws nothing (same results, same
    modeled cost, same device samples — the < 2% overhead contract);
    otherwise the drawn fault is applied exactly as documented in the
    module docstring.  ``inner_name`` exposes the wrapped backend's public
    name so the executor's fidelity shadowing and quarantine rerouting
    treat a chaos-wrapped optical backend like the optical backend itself.
    """

    def __init__(self, inner: str | ExecutionBackend = "optical-sim",
                 schedule: FaultSchedule | None = None,
                 name: str | None = None) -> None:
        self.inner: ExecutionBackend = (get_backend(inner)
                                        if isinstance(inner, str) else inner)
        self.inner_name = self.inner.name
        self.name = name or f"chaos-{self.inner.name}"
        self.schedule = schedule or FaultSchedule()

    def supports(self, category: str, ctx: BackendContext) -> bool:
        return self.inner.supports(category, ctx)

    def take_device_samples(self):
        take = getattr(self.inner, "take_device_samples", None)
        return take() if take is not None else None

    def run(self, category, xs, ctx, *, kernel=None, weights=None):
        fault = self.schedule.draw()
        if fault is None:
            return self.inner.run(category, xs, ctx, kernel=kernel,
                                  weights=weights)
        if fault.kind == "error":
            raise TransientDispatchError(
                f"injected dispatch fault (index {self.schedule.index - 1})")
        if fault.kind == "device_loss":
            n = max(1, int(getattr(ctx, "n_devices", 1)))
            if n > 1:
                # sharded dispatch: mark one logical device lost; the
                # sharded backend's scatter loop raises DeviceLostError
                # for the shard placed on it and recovers on a survivor
                ctx.lost_devices = frozenset({fault.device % n})
                try:
                    return self.inner.run(category, xs, ctx, kernel=kernel,
                                          weights=weights)
                finally:
                    ctx.lost_devices = frozenset()
            raise DeviceLostError(0)
        if fault.kind == "straggle":
            outs, cost = self.inner.run(category, xs, ctx, kernel=kernel,
                                        weights=weights)
            advance_or_sleep(getattr(ctx, "clock", None), fault.delay_s)
            return outs, cost
        # drift: results come back numerically wrong (DAC mis-range /
        # detector drift) — only the fidelity shadow can tell
        outs, cost = self.inner.run(category, xs, ctx, kernel=kernel,
                                    weights=weights)
        return [o * fault.gain for o in outs], cost


def register_chaos(inner: str = "optical-sim", *, name: str | None = None,
                   schedule: FaultSchedule | None = None,
                   **schedule_kwargs) -> str:
    """Register a chaos-wrapped backend; returns its registered name.

    ``schedule_kwargs`` build a :class:`FaultSchedule` when ``schedule``
    is not given.  Every ``get_backend`` instantiation receives a
    :meth:`FaultSchedule.fresh` copy, so each executor's fault sequence is
    deterministic from dispatch 0 and independent of other executors.
    """
    sched = schedule if schedule is not None else FaultSchedule(
        **schedule_kwargs)
    reg_name = name or f"chaos-{inner}"

    def factory() -> ChaosBackend:
        return ChaosBackend(inner, schedule=sched.fresh(), name=reg_name)

    register_backend(reg_name, factory)
    return reg_name


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
