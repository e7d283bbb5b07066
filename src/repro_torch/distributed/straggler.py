"""Trailing-median straggler deadlines, shared by training and runtime.

The fault-tolerant training runner (``repro_torch.distributed.fault``) and the
offload runtime's dispatch watchdog (``repro_torch.runtime.faults``) detect the
same pathology — a step or dispatch that takes far longer than its healthy
siblings — and before this module each grew its own copy of the detection
logic.  :class:`TrailingMedianDeadline` is the one shared policy:

* a **trailing median** of recent healthy durations is the robust baseline
  (a mean would be dragged by the very stragglers it must detect);
* the deadline is ``factor x max(median, modeled baseline, floor)`` — the
  modeled baseline (e.g. a dispatch's ``batched_step_cost`` wall) arms the
  detector from the *first* observation, before any history exists, and
  the floor keeps sub-millisecond jitter from tripping it;
* stragglers do **not** enter the healthy history (they would poison the
  median they are judged against) and are counted as consecutive
  ``strikes``; a healthy observation resets the streak.  Past ``patience``
  consecutive strikes (:attr:`exhausted`) the caller escalates — the
  training runner restarts from checkpoint, the runtime quarantines the
  device or category.

With neither history nor a baseline the deadline is ``inf`` (no signal is
no claim): the first few observations of a cold detector are always
healthy, exactly the original runner semantics.
"""

from __future__ import annotations

__all__ = ["TrailingMedianDeadline"]


class TrailingMedianDeadline:
    """Straggler detector over a stream of durations.

    Args:
      factor: deadline multiple over the healthy baseline (3.0 means a
        duration 3x the trailing median is a straggler).
      window: how many recent healthy durations back the median.
      patience: consecutive strikes before :attr:`exhausted`.
      floor_s: smallest baseline the deadline is derived from — durations
        under ``factor * floor_s`` are never stragglers, whatever the
        median says (0.0 disables the floor: pure relative detection,
        the training runner's historical behavior).
    """

    def __init__(self, *, factor: float = 3.0, window: int = 32,
                 patience: int = 3, floor_s: float = 0.0) -> None:
        if factor <= 0.0:
            raise ValueError("factor must be > 0")
        if window < 1:
            raise ValueError("window must be >= 1")
        if patience < 1:
            raise ValueError("patience must be >= 1")
        if floor_s < 0.0:
            raise ValueError("floor_s must be >= 0")
        self.factor = float(factor)
        self.window = int(window)
        self.patience = int(patience)
        self.floor_s = float(floor_s)
        self.strikes = 0
        self._healthy: list[float] = []

    @property
    def median(self) -> float:
        """Trailing median of healthy durations (``inf`` when cold)."""
        s = sorted(self._healthy)
        return s[len(s) // 2] if s else float("inf")

    @property
    def exhausted(self) -> bool:
        """True when ``patience`` consecutive stragglers have been seen."""
        return self.strikes >= self.patience

    def deadline_s(self, base_s: float | None = None) -> float:
        """Current straggler deadline in seconds.

        ``base_s`` is an optional modeled baseline for the *next*
        observation (a dispatch's modeled wall); it arms the detector
        before any healthy history exists.  ``inf`` when there is neither
        history nor a baseline.
        """
        est = self.median if self._healthy else 0.0
        if base_s is not None and base_s > 0.0:
            est = max(est, float(base_s))
        if est <= 0.0:
            return float("inf")
        return self.factor * max(est, self.floor_s)

    def observe(self, dt_s: float, base_s: float | None = None) -> bool:
        """Score one duration; True means straggler.

        Healthy durations enter the trailing window and reset the strike
        streak; stragglers are excluded from the window (they must not
        drag the median they are judged against) and extend it.
        """
        if dt_s > self.deadline_s(base_s):
            self.strikes += 1
            return True
        self.strikes = 0
        self._healthy.append(float(dt_s))
        if len(self._healthy) > self.window:
            del self._healthy[:-self.window]
        return False

    def reset_strikes(self) -> None:
        """Forgive the current streak (the training runner's post-restart
        reset: a recovered run starts with a clean record)."""
        self.strikes = 0

    def reset(self) -> None:
        """Full reset: history and strikes."""
        self.strikes = 0
        self._healthy.clear()
