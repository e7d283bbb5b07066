"""Fault tolerance & straggler mitigation for the training driver.

Single-controller runtime model (what a real pod deployment uses):
  * every step runs under a watchdog deadline derived from a trailing
    median of healthy step times (the shared
    :class:`~repro_torch.distributed.straggler.TrailingMedianDeadline` — the
    same detector the offload runtime's dispatch watchdog uses, so the
    training and serving fault stories cannot diverge) — a straggling
    step (slow host, flaky ICI link) is *detected* and counted; past
    ``straggler_patience`` consecutive stragglers the runner treats the
    step as a failure (on real fleets: reschedule the slow host, shrink
    the mesh, or restart from checkpoint — here: restart path);
  * any exception in a step (preemption, device loss — simulated in tests
    by injected faults) triggers restore-from-latest-checkpoint and replay;
    the data pipeline is step-keyed so replayed batches are bit-identical;
  * checkpoint cadence is decoupled from the loop via async saves.

The runner is deliberately jit-agnostic: it wraps *any* step callable
operating on an opaque state pytree.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed.straggler import TrailingMedianDeadline

__all__ = ["FaultTolerantRunner", "RunReport"]


@dataclasses.dataclass
class RunReport:
    steps_run: int = 0
    failures_recovered: int = 0
    stragglers_detected: int = 0
    checkpoints_written: int = 0
    final_step: int = 0
    step_times_s: list[float] = dataclasses.field(default_factory=list)


class FaultTolerantRunner:
    def __init__(self, step_fn: Callable[[Any, int], Any],
                 manager: CheckpointManager, *,
                 checkpoint_every: int = 50,
                 straggler_factor: float = 3.0,
                 straggler_patience: int = 3,
                 max_restarts: int = 10) -> None:
        self.step_fn = step_fn
        self.manager = manager
        self.checkpoint_every = checkpoint_every
        self.straggler_factor = straggler_factor
        self.straggler_patience = straggler_patience
        self.max_restarts = max_restarts

    def run(self, state: Any, start_step: int, num_steps: int,
            *, fault_hook: Callable[[int], None] | None = None) -> tuple[Any, RunReport]:
        """Run ``num_steps`` steps with recovery.  ``fault_hook(step)`` may
        raise to simulate a failure (used by the failure-injection tests)."""
        report = RunReport(final_step=start_step)
        step = start_step
        restarts = 0
        detector = TrailingMedianDeadline(factor=self.straggler_factor,
                                          patience=self.straggler_patience)
        end = start_step + num_steps
        while step < end:
            try:
                t0 = time.perf_counter()
                if fault_hook is not None:
                    fault_hook(step)
                state = self.step_fn(state, step)
                dt = time.perf_counter() - t0
                report.step_times_s.append(dt)
                if detector.observe(dt):
                    report.stragglers_detected += 1
                    if detector.exhausted:
                        raise RuntimeError(
                            f"persistent straggler: step {step} took {dt:.3f}s "
                            f"(median {detector.median:.3f}s) "
                            f"x{self.straggler_patience}")
                step += 1
                report.steps_run += 1
                if step % self.checkpoint_every == 0:
                    self.manager.save_async(step, state)
                    report.checkpoints_written += 1
            except Exception:
                restarts += 1
                report.failures_recovered += 1
                if restarts > self.max_restarts:
                    raise
                self.manager.wait()
                restored_step, restored = self.manager.restore_latest(state)
                if restored_step is None:
                    # no checkpoint yet: replay from the segment start
                    step = start_step
                else:
                    state, step = restored, restored_step
                detector.reset_strikes()
        self.manager.wait()
        report.final_step = step
        return state, report
