"""The offload executor: turns ``OffloadPlan`` decisions into execution.

Callers ``submit`` accelerable ops (fft / conv / matmul) and the executor
coalesces queued calls of the same shape into one accelerator invocation at
``flush`` time.  That is the paper's §6 batching lever made operational —
and made *real*: each group executes as ONE batched backend invocation
(stacked ``(K, H, W)`` operands, batched Pallas kernels / vmapped physics),
so a K-deep flush pays one dispatch round-trip and one kernel launch
instead of K, while per-invocation boundary costs (link handshake latency,
SLM settle/exposure, converter-lane ceil residue) amortize across the batch
in the modeled price.

Since the scheduler refactor, *flushing is a mechanism, not a policy*:
``flush``/``flush_async`` still drain the whole queue (the eager path), but
the group-releasing primitive they are built on — :meth:`OffloadExecutor.release`
— is public, and an attached
:class:`~repro_torch.runtime.scheduler.OffloadScheduler` drives it
selectively: partially filled groups stay queued ("held") across
scheduler passes until admission control says waiting can no longer raise
occupancy.  Every submission is timestamped, so held groups know their age,
telemetry knows the arrival process, and a group's queueing delay is priced
into its invocation (``StepCost.hold_s``) when a scheduler is in charge.
The executor is also a context manager: leaving the ``with`` block flushes
queued + held work and drains the pipeline, so examples and tests cannot
leak pending groups.

``flush`` is additionally *pipelined* two deep: dispatch is asynchronous
(CUDA kernels are queued on the current stream and a ``torch.cuda.Event``
is recorded after each dispatch — no premature synchronize), so while
group k's analog+ADC compute is in flight, group k+1's host-side staging
and DAC-prep proceed, and only when a third group wants to dispatch does
the oldest get retired (its event synchronized + recorded).
``flush_async`` exposes the non-blocking form: results fill immediately
with tensors still being computed, readiness is queryable per result
(:meth:`OffloadResult.done`, an ``event.query()``), and telemetry for
still in-flight groups lands at retire time (``drain`` / next flush /
``wait``).  On the CPU every result is ready the moment it is dispatched.

The executor runs on one device, the CUDA card unless the caller passes
``device="cpu"``; submitted operands are moved there, and every result
comes back there.  With ``n_devices > 1`` the ``sharded`` backends
scatter each invocation over that many logical devices
(:mod:`repro_torch.runtime.sharded`): across as many CUDA cards when the
machine has them, in turn on the executor's own device otherwise.

Execution is recorded into :class:`RuntimeTelemetry` — call counts, sample
counts, wall time, modeled cost — so ``telemetry.profiles()`` can re-enter
``plan_offload`` and the plan can be re-derived from observed traffic.
Optionally every optical-sim batch is shadowed by the host backend and
scored by a :class:`FidelityChecker`, pairing each speedup with its
quantization-error cost (shadow scoring needs concrete values, so fidelity
batches retire synchronously — validation mode trades the pipeline away).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Mapping

import numpy as np
import torch

from repro_torch.core.accelerator import (
    PROTOTYPE_4F,
    OpticalFourierAcceleratorSpec,
    OpticalMVMAcceleratorSpec,
    StepCost,
)
from repro_torch.runtime.backends import (
    BackendContext,
    ExecutionBackend,
    get_backend,
)
from repro_torch.runtime.faults import (
    DispatchWatchdog,
    FaultError,
    Quarantine,
    RetryPolicy,
    advance_or_sleep,
)
from repro_torch.runtime.fidelity import FidelityChecker, FidelityReport
from repro_torch.runtime.residency import ResidencyCache
from repro_torch.runtime.telemetry import RuntimeTelemetry
from repro_torch.runtime.tiling import MemoryBudget, choose_tile, tile_sizes
from repro_torch.runtime.tracing import Span, Tracer

__all__ = ["OffloadResult", "OffloadExecutor"]

# Backends whose batches carry quantization error worth shadow-scoring (the
# sharded backend's default inner is the optical simulator).
_SHADOWED = ("optical-sim", "sharded")


def _shadow_worthy(be: ExecutionBackend) -> bool:
    """Whether ``be``'s batches deserve fidelity shadowing.  Wrappers (the
    chaos backend) expose the wrapped backend via ``inner_name`` so a
    fault-injected optical backend is shadowed like the optical backend —
    the drift faults it injects are exactly what the shadow must catch."""
    return (be.name in _SHADOWED
            or getattr(be, "inner_name", None) in _SHADOWED)


def resolve_device(device: "str | torch.device | None") -> torch.device:
    """The executor's device: the CUDA card unless the caller names one.
    With no card present, the default raises instead of dropping to the
    CPU — a CPU run is always asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "OffloadExecutor runs on the CUDA card by default and none "
                "is available; pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _record_event(outs: list[torch.Tensor]) -> "torch.cuda.Event | None":
    """A CUDA event recorded on the current stream after a dispatch (None
    on the CPU, where the dispatch returns with its results computed)."""
    if not outs or not outs[0].is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(outs[0].device))
    return ev


def _block(event: "torch.cuda.Event | None") -> None:
    if event is not None:
        event.synchronize()


def _is_ready(event: "torch.cuda.Event | None") -> bool:
    return event is None or event.query()


class OffloadResult:
    """Handle for a submitted call; materializes at ``flush``/``flush_async``.

    Attributes (valid once ``ready``):
      value: the op result (a tensor possibly still being computed on the
        card after ``flush_async`` — usable immediately in stream order,
        complete after ``wait``).
      cost: modeled per-call share of the invocation's :class:`StepCost`.
      backend: backend name that served the call.
      batch: how many calls shared the invocation.
      fidelity: the batch's :class:`FidelityReport` (when checking is on).
    """

    def __init__(self, executor: "OffloadExecutor") -> None:
        self._executor = executor
        self.ready = False
        self.value: torch.Tensor | None = None
        self._event: "torch.cuda.Event | None" = None
        self.cost: StepCost | None = None
        self.backend: str | None = None
        self.batch: int = 0
        self.fidelity: FidelityReport | None = None

    def get(self) -> torch.Tensor:
        if not self.ready:
            self._executor.flush()
        else:
            self.wait()
        return self.value

    def done(self) -> bool:
        """True when the underlying device computation has completed.

        ``ready`` means the handle is filled (dispatch happened); ``done``
        additionally means the value would materialize without blocking.
        """
        return self.ready and _is_ready(self._event)

    def wait(self) -> "OffloadResult":
        """Block until this result's computation (and its telemetry) lands."""
        if not self.ready:
            self._executor.flush()
        self._executor._retire_containing(self)
        _block(self._event)
        return self

    def _fill(self, value: torch.Tensor, cost: StepCost, backend: str,
              batch: int, fidelity: FidelityReport | None,
              event: "torch.cuda.Event | None") -> None:
        self.value = value
        self._event = event
        self.cost = cost
        self.backend = backend
        self.batch = batch
        self.fidelity = fidelity
        self.ready = True


@dataclasses.dataclass
class _Pending:
    category: str
    x: torch.Tensor
    kernel: torch.Tensor | None
    weights: torch.Tensor | None
    backend: str
    result: OffloadResult
    t_submit: float = 0.0   # executor-clock submission timestamp
    call_id: int = 0        # monotone per-executor submission index

    def group_key(self) -> tuple:
        return (self.category, self.backend, tuple(self.x.shape),
                str(self.x.dtype), id(self.kernel), id(self.weights))


@dataclasses.dataclass
class _Inflight:
    """One dispatched-but-unretired batched invocation."""

    chunk: list[_Pending]
    be: ExecutionBackend
    outs: list[torch.Tensor]
    modeled: StepCost | None
    t0: float
    dispatch_s: float  # host time spent staging + dispatching (be.run)
    event: "torch.cuda.Event | None" = None  # recorded after the dispatch
    device_samples: list[tuple[int, int]] | None = None  # sharded dispatch
    shadow: bool = False  # fidelity shadow-scoring owed at retire
    hold_s: float = 0.0   # scheduler hold time priced into this invocation
    span: Span | None = None      # open invocation span (tracing on)
    t_stage_end: float = 0.0      # tracer-clock time staging finished
    wkey: tuple = ()              # (category, requested backend) window key


class OffloadExecutor:
    """Queue + batcher + two-deep pipeline in front of the backend registry.

    Args:
      spec: accelerator priced/simulated by the analog backends.
      default_backend: where submits go when the caller (or router) does
        not name one.
      telemetry: shared :class:`RuntimeTelemetry` (created if omitted).
      fidelity: optional :class:`FidelityChecker`; when set, optical-sim
        batches are shadowed by the host backend and scored (validation
        mode — the shadow run is excluded from telemetry, and fidelity
        batches retire synchronously, bypassing the async pipeline).
      max_batch: largest number of calls coalesced into one invocation.
        A global ceiling; per-category ceilings (``set_max_batch``) let the
        router adapt coalescing depth per category without touching it.
      pipeline_depth: how many batched invocations may be in flight at
        once *per engine* — each ``(category, backend)`` pair owns its own
        in-flight window of this depth, so an fft group on the optical
        engine, a conv group on another, and a host-fallback group all
        overlap instead of serializing behind one shared deque (the
        pipeline is a small DAG; retirement stays submit-order *within*
        each engine).  2 (default) double-buffers each engine's boundary:
        group k+1 stages while group k computes.  1 restores strictly
        serial dispatch-then-block crossings per engine.  Per-category
        depths (``set_pipeline_window``) let the router adapt window depth
        per engine; the global value is the default/back-compat alias
        every unpinned category inherits.
      shared_window: ``True`` restores the pre-per-engine discipline — ONE
        global ``pipeline_depth``-deep window shared by every engine, so
        dispatching any invocation retires the globally oldest one
        regardless of engine.  The measured baseline per-engine windows
        are benched against.
      n_devices: how many replicated simulated accelerators the
        ``sharded`` backend scatters each invocation across.  A global
        ceiling; per-category counts (``set_n_devices``) let the router
        adapt the device fan-out per category, the same way
        ``set_max_batch`` adapts coalescing depth.  Each logical device
        is a CUDA card of its own when the machine has that many
        (``repro_torch.distributed.sharding.shard_devices``); otherwise
        the shards run in turn on ``device``, with identical numerics.
      shard_mode: the sharded backend's split policy (``auto`` / ``group``
        / ``frame`` — see ``repro_torch.runtime.sharded``).
      mem_budget: per-device staging byte budget
        (:class:`~repro_torch.runtime.tiling.MemoryBudget`).  ``None``
        (default) detects it for ``device``: L2-derived on a CUDA card,
        LLC-derived on the CPU.  A released
        group whose monolithic ``(K, H, W)`` stack would overflow the
        budget streams as ``ceil(K / tile_k)`` budget-sized sub-invocations
        through the two-deep pipeline instead (``choose_tile``); pass
        ``MemoryBudget.unlimited()`` to restore monolithic dispatch.
      tile_k: explicit frames-per-tile override (global; per-category
        overrides via ``set_tile_k``).  ``None`` derives it from
        ``mem_budget`` per released group — small frames never tile, a
        512x512 K=16 group streams in budget-sized chunks.
      clock: timebase for submission timestamps, hold accounting, and the
        telemetry arrival-rate estimate (``time.perf_counter`` by default;
        tests and benchmarks inject a manual clock for deterministic
        admission decisions).
      retry: the per-dispatch fault policy
        (:class:`~repro_torch.runtime.faults.RetryPolicy`; a default one if
        omitted).  Every batched invocation runs under it: a dispatch
        raising :class:`~repro_torch.runtime.faults.FaultError` is retried with
        exponential, jittered backoff (slept through ``clock``); when every
        attempt faults the dispatch degrades to ``retry.fallback`` (host)
        and the category is quarantined so subsequent dispatches reroute
        immediately.  The policy also configures the dispatch watchdog
        (straggler deadlines from modeled wall x trailing median) and the
        quarantine windows.
      residency: the device-side operand residency cache
        (:class:`~repro_torch.runtime.residency.ResidencyCache`).  ``None``
        (default) keeps the historical stage-every-flush behavior — every
        modeled price and every result is bit-identical to before.  Pass
        ``True`` to build a cache sized against ``mem_budget`` (residency
        and tile staging share the budget's spendable bytes), or a
        pre-built :class:`ResidencyCache` to share one across executors.
        With a cache attached, repeat flushes of unchanged operands skip
        host staging and are priced read-side-only
        (``batched_step_cost(resident_frames=...)``), sharded dispatch
        keeps per-device resident shard sets, and hit/miss/eviction
        counters land in telemetry (``residency_counts``) and the trace
        (``cache`` instants).
      device: where operands are staged and every backend computes.
        ``None`` (default) is the CUDA card, and raises when none is
        present; pass ``"cpu"`` to run on the CPU.
      tracer: optional :class:`~repro_torch.runtime.tracing.Tracer`.  When set,
        every dispatch emits a boundary-attributed span tree (submit ->
        held -> release -> invocation -> stage -> compute ->
        fidelity-shadow, with per-device scatter children under sharded
        dispatch) plus counters/histograms in ``tracer.metrics``.  The
        default ``None`` is a measured no-op: instrumentation sites guard
        on the attribute and add no dispatch work.  For exact span
        durations in tests, give the tracer the same manual clock as
        ``clock``.

    Use as a context manager to guarantee nothing leaks: ``__exit__``
    flushes queued *and* scheduler-held work, then drains the pipeline.
    """

    def __init__(self,
                 spec: OpticalFourierAcceleratorSpec |
                       OpticalMVMAcceleratorSpec = PROTOTYPE_4F,
                 *,
                 default_backend: str = "optical-sim",
                 telemetry: RuntimeTelemetry | None = None,
                 fidelity: FidelityChecker | None = None,
                 max_batch: int = 32,
                 pipeline_depth: int = 2,
                 n_devices: int = 1,
                 shard_mode: str = "auto",
                 mem_budget: MemoryBudget | None = None,
                 tile_k: int | None = None,
                 shared_window: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 retry: RetryPolicy | None = None,
                 residency: "ResidencyCache | bool | None" = None,
                 tracer: Tracer | None = None,
                 device: "str | torch.device | None" = None) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if shard_mode not in ("auto", "group", "frame"):
            raise ValueError("shard_mode must be 'auto', 'group' or 'frame'")
        if tile_k is not None and tile_k < 1:
            raise ValueError("tile_k must be >= 1")
        self.device = resolve_device(device)
        if mem_budget is None:
            mem_budget = MemoryBudget.detect(self.device)
        self.ctx = BackendContext(spec=spec, device=self.device,
                                  pipeline_depth=pipeline_depth,
                                  n_devices=n_devices, shard_mode=shard_mode,
                                  mem_budget=mem_budget, tracer=tracer,
                                  clock=clock)
        self.tracer = tracer
        self.default_backend = default_backend
        self.telemetry = telemetry or RuntimeTelemetry()
        self.fidelity = fidelity
        self.retry = retry or RetryPolicy()
        self.quarantine = Quarantine(window_s=self.retry.quarantine_s,
                                     probation_s=self.retry.probation_s,
                                     patience=self.retry.straggler_patience)
        self._watchdog = DispatchWatchdog(
            factor=self.retry.straggler_factor,
            window=self.retry.straggler_window,
            floor_s=self.retry.straggler_floor_s,
            patience=self.retry.straggler_patience)
        # fault-handling collaborators travel with the dispatch context so
        # the sharded backend quarantines devices through the same policy
        self.ctx.quarantine = self.quarantine
        self.ctx.watchdog = self._watchdog
        self.ctx.telemetry = self.telemetry
        if residency is True:
            residency = ResidencyCache(mem_budget)
        elif residency is False:
            residency = None
        self.residency: ResidencyCache | None = residency
        self.ctx.residency = residency
        self.max_batch = max_batch
        self.pipeline_depth = pipeline_depth
        self.n_devices = n_devices
        self.mem_budget = mem_budget
        self.tile_k = tile_k
        self.shared_window = shared_window
        self._category_max_batch: dict[str, int] = {}
        self._category_n_devices: dict[str, int] = {}
        self._category_tile_k: dict[str, int] = {}
        self._category_window: dict[str, int] = {}
        self._clock = clock
        self._queue: list[_Pending] = []
        self._inflight: collections.deque[_Inflight] = collections.deque()
        self._last_retire_end = 0.0
        self._n_submitted = 0
        # tracer-clock end of the last charged compute span: leaf compute
        # spans start no earlier, so they never overlap within the device
        # lane (the same never-double-bill rule _retire's wall uses)
        self._trace_compute_end = 0.0
        self._backends: dict[str, ExecutionBackend] = {}
        # id -> (caller's kernel/weights operand, its tensor on the device):
        # repeat submits of one host operand keep one device tensor, so
        # they still group together (groups key on operand identity)
        self._operands: dict[int, tuple] = {}
        # the admission-control policy driving release decisions, when one
        # is attached (the reference's OffloadScheduler); None means
        # the classic eager regime: every flush drains the queue
        self._scheduler = None

    @property
    def spec(self):
        return self.ctx.spec

    def now(self) -> float:
        """Current executor-clock time.  Quarantine windows, probation
        checks, and the router's quarantine-aware fan-out shrink all read
        this timebase, so the whole fault lifecycle replays exactly under
        an injected manual clock (any callable with an ``advance`` method)."""
        return self._clock()

    # -- per-category batching ceilings ---------------------------------------
    def max_batch_for(self, category: str) -> int:
        """Effective coalescing ceiling for ``category`` (global cap applies)."""
        return min(self._category_max_batch.get(category, self.max_batch),
                   self.max_batch)

    def set_max_batch(self, category: str, k: int) -> None:
        """Set a per-category coalescing ceiling (the adaptive-batching hook
        ``PlanRouter.replan`` drives from observed occupancy + deadline)."""
        if k < 1:
            raise ValueError("max_batch must be >= 1")
        self._category_max_batch[category] = k

    def category_max_batches(self) -> Mapping[str, int]:
        return dict(self._category_max_batch)

    # -- per-category device fan-out -------------------------------------------
    def n_devices_for(self, category: str) -> int:
        """Effective sharded device count for ``category`` (global cap
        applies — the fleet has only ``n_devices`` accelerators)."""
        return min(self._category_n_devices.get(category, self.n_devices),
                   self.n_devices)

    def set_n_devices(self, category: str, n: int) -> None:
        """Set a per-category sharded device count (the adaptive hook
        ``PlanRouter.replan`` drives alongside ``set_max_batch``)."""
        if n < 1:
            raise ValueError("n_devices must be >= 1")
        self._category_n_devices[category] = n

    def category_n_devices(self) -> Mapping[str, int]:
        return dict(self._category_n_devices)

    # -- per-engine pipeline windows -------------------------------------------
    def pipeline_window_for(self, category: str) -> int:
        """Effective in-flight window depth for ``category``'s engine.  The
        global ``pipeline_depth`` is the default every unpinned category
        inherits — the back-compat alias: with no pins and
        ``shared_window=False`` a single-category workload behaves exactly
        like the historical global window."""
        return max(1, self._category_window.get(category,
                                                self.pipeline_depth))

    def set_pipeline_window(self, category: str, depth: int) -> None:
        """Set a per-category in-flight window depth (the adaptive hook
        ``PlanRouter.replan`` drives alongside ``set_max_batch`` /
        ``set_n_devices`` / ``set_tile_k``)."""
        if depth < 1:
            raise ValueError("pipeline window depth must be >= 1")
        self._category_window[category] = depth

    def category_windows(self) -> Mapping[str, int]:
        return dict(self._category_window)

    # -- per-category tile depth (memory-budgeted dispatch) --------------------
    def set_tile_k(self, category: str, t: int) -> None:
        """Pin ``category``'s frames-per-tile (the adaptive hook
        ``PlanRouter.replan`` drives alongside ``set_max_batch`` /
        ``set_n_devices``).  Overrides the budget-derived choice."""
        if t < 1:
            raise ValueError("tile_k must be >= 1")
        self._category_tile_k[category] = t

    def category_tile_ks(self) -> Mapping[str, int]:
        return dict(self._category_tile_k)

    def resolve_tile_k(self, category: str, x: torch.Tensor, depth: int, *,
                       weights: torch.Tensor | None = None) -> int:
        """Frames per sub-invocation for a ``depth``-deep released run of
        ``x``-shaped calls: the per-category pin, the global ``tile_k``
        override, or — when neither is set — :func:`choose_tile` against
        the memory budget.  This is the ONE resolution path; ``warm``,
        dispatch, and (via the same ``choose_tile``) the router's
        ``choose_sharding`` all go through it, so the stack shapes primed
        are exactly the stack shapes flushed and the planned tile is the
        dispatched tile.  The per-call output size enters the working-set
        model too — a matmul's result footprint is set by the weights'
        trailing dim, not the operand's."""
        t = self._category_tile_k.get(category, self.tile_k)
        if t is None:
            n_out = (int(x.shape[0]) * int(weights.shape[-1])
                     if category == "matmul" and weights is not None
                     else x.numel())
            t = choose_tile(x.numel(), depth, self.effective_mem_budget(),
                            n_out=n_out,
                            dtype_bytes=max(1, x.element_size()),
                            pipeline_depth=self.pipeline_window_for(
                                category)).tile_k
        return max(1, min(int(t), depth))

    def effective_mem_budget(self) -> MemoryBudget:
        """The staging budget tiles are chosen against *right now*: the
        configured budget minus whatever the residency cache currently
        pins (resident stacks are live allocations in the same pool — see
        ``MemoryBudget.minus``).  With no cache this is exactly
        ``mem_budget``."""
        if self.residency is None:
            return self.mem_budget
        return self.residency.effective_budget(self.mem_budget)

    def _backend(self, name: str) -> ExecutionBackend:
        if name not in self._backends:
            self._backends[name] = get_backend(name)
        return self._backends[name]

    def _validate(self, category: str, backend: str | None,
                  kernel: torch.Tensor | None,
                  weights: torch.Tensor | None) -> str:
        name = backend or self.default_backend
        be = self._backend(name)
        if not be.supports(category, self.ctx):
            raise ValueError(
                f"backend {name!r} does not support category {category!r} "
                f"on spec {self.ctx.spec.name!r}")
        if category == "conv" and kernel is None:
            raise ValueError("conv requires kernel=")
        if category == "matmul" and weights is None:
            raise ValueError("matmul requires weights=")
        return name

    # -- lifetime --------------------------------------------------------------
    def attach_scheduler(self, scheduler) -> None:
        """Install the admission-control policy that decides when queued
        groups release (``OffloadScheduler`` calls this; ``None`` detaches
        and restores the eager drain-on-flush regime)."""
        self._scheduler = scheduler

    @property
    def scheduler(self):
        return self._scheduler

    def __enter__(self) -> "OffloadExecutor":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # Drain even when unwinding an exception: handles given out must
        # not be left forever-pending, and telemetry must balance.  When
        # the body raised, drain errors are swallowed so the body's
        # exception is never masked by cleanup.
        self.close(unwinding=exc_type is not None)
        return False

    def close(self, *, unwinding: bool = False) -> None:
        """Release every scheduler-held group and retire every in-flight
        invocation, letting no submitted frame drop silently — even when a
        release raises partway (the remaining groups still drain; the first
        error re-raises afterwards).  ``unwinding=True`` (the exception
        path of ``__exit__``) swallows drain errors instead so the caller's
        exception survives the cleanup."""
        first: BaseException | None = None
        for key in list(self.pending_groups()):
            try:
                self.release(key, reason="close")
            except BaseException as e:
                if first is None:
                    first = e
        while self._inflight:
            try:
                self._retire(self._inflight.popleft())
            except BaseException as e:
                if first is None:
                    first = e
        if first is not None and not unwinding:
            raise first

    # -- client API ------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        """``x`` as a tensor on the executor's device (no copy when it is
        one already)."""
        if isinstance(x, torch.Tensor):
            return x if x.device == self.device else x.to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _operand(self, x) -> torch.Tensor | None:
        """A kernel/weights operand on the device, converted once per
        caller object (held by reference, so its id cannot be recycled
        while the entry lives)."""
        if x is None or (isinstance(x, torch.Tensor)
                         and x.device == self.device):
            return x
        hit = self._operands.get(id(x))
        if hit is not None and hit[0] is x:
            return hit[1]
        if len(self._operands) >= 64:
            self._operands.clear()
        t = self._to_device(x)
        self._operands[id(x)] = (x, t)
        return t

    def submit(self, category: str, x, *, kernel=None, weights=None,
               backend: str | None = None,
               reuse: str | None = None) -> OffloadResult:
        """Queue one call; returns a handle materialized at ``flush``.

        ``reuse`` names an explicit residency token: the caller promises
        that every submission under this token carries the same operand
        content, so after the first sighting the content digest is served
        from the token instead of re-hashing the array
        (:meth:`ResidencyCache.note_token`).  Purely an optimization over
        the automatic digest path — with no residency cache attached it is
        accepted and ignored.

        ``x``, ``kernel`` and ``weights`` may be tensors anywhere or numpy
        arrays: they are moved to the executor's device.
        """
        x = self._to_device(x)
        kernel, weights = self._operand(kernel), self._operand(weights)
        name = self._validate(category, backend, kernel, weights)
        if reuse is not None and self.residency is not None:
            self.residency.note_token(reuse, x, self.ctx)
        result = OffloadResult(self)
        t = self._clock()
        self.telemetry.note_submit(category, t)
        self._n_submitted += 1
        if self.tracer is not None:
            self.tracer.instant("submit", lane="sched", category=category,
                                backend=name, call_id=self._n_submitted)
        self._queue.append(_Pending(category, x, kernel, weights, name,
                                    result, t_submit=t,
                                    call_id=self._n_submitted))
        return result

    def run(self, category: str, x, **kwargs) -> torch.Tensor:
        """Convenience: submit one call and flush immediately."""
        return self.submit(category, x, **kwargs).get()

    def warm(self, category: str, x, *, kernel=None, weights=None,
             backend: str | None = None,
             batch: int | None = None) -> None:
        """Execute once without recording: primes the per-shape factor/mask
        caches, the kernels' build and the library plans, so first-call
        set-up time does not pollute measured profiles (call before
        ``telemetry.start()``).

        Library plans (cuFFT, cuBLAS) are made per *stacked* shape, so
        priming only the single-item shape would leave the first real
        flush paying the batched set-up.  This warms the single-item
        ``(1, ...)`` stack plus every stack shape a ``batch``-deep release
        would actually dispatch (``batch`` defaults to the category's
        effective ``max_batch`` ceiling).  Under memory-budgeted tiling
        that is NOT one ``(batch, ...)`` stack: the release streams as
        ``tile_k``-sized sub-invocations (plus a ragged tail tile), and
        ``warm`` resolves ``tile_k`` through the same
        :meth:`resolve_tile_k` path dispatch uses — same budget, same
        per-category pins — so the first tiled flush pays no set-up.  A
        ragged group tail (K % max_batch calls) still sets up on first
        encounter — call ``warm`` again with ``batch=tail`` when the tail
        size is known and the measurement window cannot tolerate it.

        Sharded dispatch shapes are primed too: the per-category device
        count is written into the context exactly as ``flush`` does it, so
        a sharded backend warms the same per-device shard stacks (and conv
        halo tiles) the first real sharded flush will dispatch, instead of
        whatever stale device count the context last held.
        """
        x = self._to_device(x)
        kernel, weights = self._operand(kernel), self._operand(weights)
        name = self._validate(category, backend, kernel, weights)
        be = self._backend(name)
        if batch is None:
            batch = self.max_batch_for(category)
        if batch < 1:
            raise ValueError("batch must be >= 1")
        # the category fan-out and per-engine window depth are written for
        # priming but must not leak into the shared context after the warm
        # call: the context's pipeline depth feeds both the tile choice and
        # the backends' modeled price, so warm primes the exact depth and
        # device count dispatch will run this category at, then restores
        # them.
        saved_nd, self.ctx.n_devices = \
            self.ctx.n_devices, self.n_devices_for(category)
        saved_pd, self.ctx.pipeline_depth = \
            self.ctx.pipeline_depth, self.pipeline_window_for(category)
        tile = self.resolve_tile_k(category, x, batch, weights=weights)
        # warm-up runs are not workload: suppress backend-side tracing so
        # priming does not litter the trace with orphan device spans, the
        # straggler watchdog so first-call set-up time can never strike
        # (let alone quarantine) a healthy device, and the residency cache
        # so priming stacks neither pollute the resident set nor skew the
        # hit-rate ledger the router replans from
        saved, self.ctx.tracer = self.ctx.tracer, None
        saved_wd, self.ctx.watchdog = self.ctx.watchdog, None
        saved_res, self.ctx.residency = self.ctx.residency, None
        try:
            for b in sorted({1} | set(tile_sizes(batch, tile))):
                outs, _ = be.run(category, [x] * b, self.ctx,
                                 kernel=kernel, weights=weights)
                _block(_record_event(outs))
        finally:
            self.ctx.tracer = saved
            self.ctx.watchdog = saved_wd
            self.ctx.residency = saved_res
            self.ctx.pipeline_depth = saved_pd
            self.ctx.n_devices = saved_nd

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        """Dispatched batched invocations not yet retired (blocked+recorded)."""
        return len(self._inflight)

    # -- the pipelined batcher -------------------------------------------------
    def flush(self) -> list[OffloadResult]:
        """Execute everything queued and block until all results landed.

        The blocking wrapper around :meth:`flush_async` + :meth:`drain`:
        groups still overlap in flight while the flush proceeds, but by
        return time every result is concrete and recorded.
        """
        done = self.flush_async()
        self.drain()
        return done

    def pending_groups(self) -> dict[tuple, list[_Pending]]:
        """Queued submissions grouped exactly as dispatch would group them
        (category, backend, shape, dtype, operand identity), submission
        order preserved within each group.  This is the scheduler's view of
        the held queue — entries expose ``category`` and ``t_submit`` for
        admission decisions.  The mapping is a snapshot; mutate the queue
        only through :meth:`release` / :meth:`flush_async`."""
        groups: dict[tuple, list[_Pending]] = {}
        for p in self._queue:
            groups.setdefault(p.group_key(), []).append(p)
        return groups

    def release(self, key: tuple, count: int | None = None, *,
                reason: str = "flush") -> list[OffloadResult]:
        """Dispatch the first ``count`` queued members of group ``key``
        (all of them by default), leaving the rest *held* in the queue.

        This is the primitive the :class:`OffloadScheduler` drives:
        ``flush_async`` is simply "release every group whole".  Each
        released run of members dispatches as ceil(n / max_batch) batched
        chunks through the async pipeline — and each chunk, when its
        monolithic stack would overflow the memory budget, streams as
        ceil(chunk / tile_k) tiled sub-invocations (see
        :meth:`resolve_tile_k`) that double-buffer against each other.
        Hold time (dispatch minus oldest member's submit) is priced into
        each invocation when a scheduler is attached.

        ``reason`` records *why* the release happened in the trace (the
        scheduler passes its admission verdict: ``full`` / ``due`` /
        ``futile``; eager paths pass ``flush``).
        """
        members = [p for p in self._queue if p.group_key() == key]
        if count is not None:
            members = members[:count]
        if not members:
            return []
        chosen = set(map(id, members))
        self._queue = [p for p in self._queue if id(p) not in chosen]
        tr = self.tracer
        rel = None
        if tr is not None:
            rel = tr.begin("release", lane="sched", reason=reason,
                           category=members[0].category, count=len(members))
            tr.metrics.counter("release", reason=reason).inc()
        done: list[OffloadResult] = []
        cap = self.max_batch_for(members[0].category)
        for i in range(0, len(members), cap):
            chunk = members[i:i + cap]
            self._dispatch_async(chunk, reason=reason, parent=rel)
            done.extend(p.result for p in chunk)
        if rel is not None:
            tr.end(rel)
        return done

    def flush_async(self) -> list[OffloadResult]:
        """Execute everything queued without a final barrier.

        Requests group on (category, backend, shape, dtype, operand
        identity); each group dispatches as ceil(K / max_batch) batched
        invocations, preserving submission order within a group.  Each
        invocation is dispatched asynchronously and its results are filled
        immediately with async values (``ready`` is True, ``done()`` may
        not be); at most ``pipeline_depth`` invocations stay in flight, so
        dispatching invocation k+depth first retires invocation k (blocks
        it and records telemetry).  Invocations still in flight on return
        retire at the next flush, ``drain``, or ``result.wait()``.

        With a scheduler attached this is the *force-release* path (used by
        ``flush``, ``drain``, ``OffloadResult.get`` and the context-manager
        exit): held groups dispatch immediately, with their accumulated
        hold time priced in.  Scheduler-paced release goes through
        :meth:`release` via ``OffloadScheduler.poll`` instead.
        """
        done: list[OffloadResult] = []
        for key in list(self.pending_groups()):
            done.extend(self.release(key))
        return done

    def drain(self) -> None:
        """Retire every in-flight invocation (block + record telemetry).

        With a scheduler attached, scheduler-held groups release first —
        ``drain`` is the "nothing may remain pending" barrier, and a held
        group is pending work the barrier must cover.
        """
        if self._scheduler is not None and self._queue:
            self.flush_async()
        while self._inflight:
            self._retire(self._inflight.popleft())

    def _retire_containing(self, result: OffloadResult) -> None:
        """Retire in-flight invocations up to the one holding ``result``.

        Retirement is in dispatch order *within the result's engine window*
        (category, backend) — the per-engine DAG discipline: waiting on an
        fft result must not block-and-bill an unrelated conv engine's
        still-computing window.  ``shared_window=True`` restores the
        historical global dispatch-order drain."""
        target = next((g for g in self._inflight
                       if any(p.result is result for p in g.chunk)), None)
        if target is None:
            return
        while self._inflight:
            if self.shared_window:
                g = self._inflight.popleft()
            else:
                g = next((g for g in self._inflight
                          if g.wkey == target.wkey), None)
                if g is None:
                    return
                self._inflight.remove(g)
            self._retire(g)
            if g is target:
                return

    def _retire_matching(self, wkey: tuple) -> None:
        """Retire the oldest in-flight invocation of engine ``wkey`` — the
        per-engine window gate's eviction: a full fft window retires fft's
        oldest group, never a conv group that happens to be globally
        older.  Dispatch order is preserved per engine (the deque is
        scanned front to back)."""
        for i, g in enumerate(self._inflight):
            if g.wkey == wkey:
                del self._inflight[i]
                self._retire(g)
                return

    def _dispatch_async(self, chunk: list[_Pending], *,
                        reason: str = "flush",
                        parent: Span | None = None) -> None:
        """Dispatch one released chunk, tiled against the memory budget.

        A chunk whose monolithic ``(K, H, W)`` stack fits the staging
        budget dispatches whole (one batched invocation, the classic
        path).  A chunk that would overflow it streams as
        ``ceil(K / tile_k)`` sub-invocations instead — each a full batched
        invocation of its own (stacked operands, one backend dispatch,
        optionally sharded across devices) fed through the SAME two-deep
        async pipeline, so tile t+1's host-side staging and DAC-prep
        overlap tile t's in-flight analog+read compute.  ``tile_k = 1``
        degenerates to the looped regime, ``tile_k >= K`` to the
        monolithic one.
        """
        head = chunk[0]
        tile = self.resolve_tile_k(head.category, head.x, len(chunk),
                                   weights=head.weights)
        start = 0
        sizes = tile_sizes(len(chunk), tile)
        # Device-resident sharded dispatch: commit ONE sharded placement
        # for the whole released chunk before tiling, so every tile's
        # sub-stack routes through the same resident shards instead of
        # re-scattering per tile (and repeat flushes of unchanged frames
        # skip the host->device hop entirely).  Duck-typed: only backends
        # that shard (and only with a residency cache attached) have the
        # hook; without it dispatch is bit-identical to before.
        commit = getattr(self._backend(head.backend),
                         "commit_placement", None)
        if commit is not None and self.ctx.residency is not None:
            self.ctx.n_devices = self.n_devices_for(head.category)
            commit(head.category, [p.x for p in chunk], self.ctx,
                   kernel=head.kernel, weights=head.weights,
                   tile_sizes=sizes)
        for t, size in enumerate(sizes):
            self._dispatch_invocation(chunk[start:start + size],
                                      reason=reason, parent=parent,
                                      tile=t, tiles=len(sizes))
            start += size

    def _reroute_quarantined(self, category: str,
                             be: ExecutionBackend) -> ExecutionBackend:
        """The quarantine fast-path: while ``(category,)``'s backend is
        quarantined (retry exhaustion / fidelity drift), dispatches go
        straight to the fallback instead of re-paying the retry ladder.
        After the window expires, dispatch returns to the original backend
        on probation — re-offending there doubles the next window."""
        policy = self.retry
        if be.name == policy.fallback:
            return be
        if not self.quarantine.is_quarantined(("category", category),
                                              self._clock()):
            return be
        fb = self._backend(policy.fallback)
        if not fb.supports(category, self.ctx):
            return be
        self.telemetry.note_fault(category, "reroute")
        if self.tracer is not None:
            self.tracer.instant("fallback", lane="sched", category=category,
                                backend=be.name, to=fb.name,
                                reason="quarantined")
            self.tracer.metrics.counter("reroutes", category=category).inc()
        return fb

    def _run_guarded(self, be: ExecutionBackend, head: _Pending,
                     xs: list, *, parent: Span | None = None):
        """One batched invocation under the retry policy.

        Returns ``(outs, modeled, served_backend)``.  A dispatch raising
        :class:`FaultError` retries on the same backend with exponential
        jittered backoff (slept through the injected clock); exhausting
        ``max_attempts`` degrades to the fallback backend — which always
        returns correct results, preserving the runtime-equivalence
        invariant — and quarantines the category.  Successful dispatch
        walls feed the straggler watchdog: a wall past ``factor x
        max(trailing median, modeled wall, floor)`` is counted and traced
        as a straggle fault (detection only at this level — device-level
        quarantine lives in the sharded backend, category quarantine in
        the exhaustion/drift paths, so a noisy host clock can never
        quarantine a healthy backend).
        """
        tr = self.tracer
        cat = head.category
        policy = self.retry
        t_first_fault: float | None = None
        for attempt in range(1, policy.max_attempts + 1):
            t0 = self._clock()
            try:
                outs, modeled = be.run(cat, xs, self.ctx,
                                       kernel=head.kernel,
                                       weights=head.weights)
            except FaultError as e:
                if t_first_fault is None:
                    t_first_fault = t0
                self.telemetry.note_fault(cat, e.kind)
                if tr is not None:
                    tr.instant("fault", lane="sched", parent=parent,
                               category=cat, backend=be.name, kind=e.kind,
                               attempt=attempt)
                    tr.metrics.counter("faults", category=cat,
                                       kind=e.kind).inc()
                if attempt >= policy.max_attempts:
                    break
                backoff = policy.backoff_for(attempt)
                rt0 = tr.now() if tr is not None else 0.0
                advance_or_sleep(self._clock, backoff)
                if tr is not None:
                    tr.record("retry", rt0, tr.now(), lane="sched",
                              kind="async", parent=parent, category=cat,
                              backend=be.name, attempt=attempt,
                              backoff_s=backoff)
                    tr.metrics.counter("retries", category=cat,
                                       backend=be.name).inc()
                continue
            elapsed = self._clock() - t0
            base = modeled.total_s if modeled is not None else None
            if self._watchdog.observe((cat, be.name), elapsed, base):
                self.telemetry.note_fault(cat, "straggle")
                if tr is not None:
                    tr.instant("fault", lane="sched", parent=parent,
                               category=cat, backend=be.name,
                               kind="straggle", elapsed_s=elapsed)
                    tr.metrics.counter("faults", category=cat,
                                       kind="straggle").inc()
            else:
                self.quarantine.note_healthy(("category", cat))
            if t_first_fault is not None:
                dt = self._clock() - t_first_fault
                self.telemetry.note_recovery(cat, dt)
                if tr is not None:
                    tr.metrics.histogram("recovery_s",
                                         category=cat).record(dt)
            return outs, modeled, be
        # every attempt faulted: graceful degradation — the fallback is
        # always correct, so the caller still gets its results in order
        fb = self._backend(policy.fallback)
        ev = self.quarantine.quarantine(("category", cat), self._clock(),
                                        reason="retry-exhausted")
        self.telemetry.note_fault(cat, "fallback")
        if tr is not None:
            tr.instant("fallback", lane="sched", parent=parent,
                       category=cat, backend=be.name, to=fb.name,
                       reason="retry-exhausted")
            q0 = tr.now()
            tr.record("quarantine", q0, q0 + (ev.until - ev.t), lane="sched",
                      kind="async", parent=parent, key=str(ev.key),
                      reason=ev.reason, level=ev.level)
            tr.metrics.counter("fallbacks", category=cat,
                               backend=be.name).inc()
            tr.metrics.counter("quarantines", reason=ev.reason).inc()
        outs, modeled = fb.run(cat, xs, self.ctx, kernel=head.kernel,
                               weights=head.weights)
        if t_first_fault is not None:
            dt = self._clock() - t_first_fault
            self.telemetry.note_recovery(cat, dt)
            if tr is not None:
                tr.metrics.histogram("recovery_s", category=cat).record(dt)
        return outs, modeled, fb

    def _dispatch_invocation(self, chunk: list[_Pending], *,
                             reason: str = "flush",
                             parent: Span | None = None,
                             tile: int = 0, tiles: int = 1) -> None:
        # Keep at most one *window* of invocations in flight per engine:
        # retiring here is what makes each engine's pipeline window-deep
        # rather than unbounded (frame buffers are finite), and it blocks
        # on that engine's *oldest* invocation while this chunk's host-side
        # staging below overlaps it.  Engines gate independently — a full
        # fft window never forces a conv retirement (shared_window=True
        # restores the historical single global window).
        head = chunk[0]
        wkey = (head.category, head.backend)
        if self.shared_window:
            depth = self.pipeline_depth
            while len(self._inflight) >= depth:
                self._retire(self._inflight.popleft())
        else:
            depth = self.pipeline_window_for(head.category)
            while sum(1 for g in self._inflight if g.wkey == wkey) >= depth:
                self._retire_matching(wkey)
        occupancy = 1 + sum(1 for g in self._inflight if g.wkey == wkey)
        self.telemetry.note_window(head.category, head.backend,
                                   in_flight=occupancy, depth=depth)
        be = self._reroute_quarantined(head.category,
                                       self._backend(head.backend))
        xs = [p.x for p in chunk]
        # per-category device fan-out and window depth, written the same
        # way warm() writes them (the context's depth feeds the backends'
        # modeled pipeline collapse)
        self.ctx.n_devices = self.n_devices_for(head.category)
        self.ctx.pipeline_depth = depth
        # Queueing delay under admission control: age of the oldest
        # coalesced call at dispatch.  Only priced when a scheduler is in
        # charge — eager flushes dispatch at submit granularity and their
        # sub-microsecond queue residence would just add noise to the
        # deterministic modeled columns benchmarks assert on.
        hold_s = (self._clock() - min(p.t_submit for p in chunk)
                  if self._scheduler is not None else 0.0)
        tr = self.tracer
        inv = None
        t_stage_end = 0.0
        if tr is not None:
            inv = tr.begin("invocation", lane="host", parent=parent,
                           category=head.category, backend=head.backend,
                           batch=len(chunk), tile=tile, tiles=tiles,
                           reason=reason,
                           call_ids=[p.call_id for p in chunk],
                           window_depth=depth,
                           window_occupancy=occupancy)
            if hold_s > 0.0:
                # retrospective: the hold window ended now, at dispatch
                t_now = tr.now()
                tr.record("held", max(t_now - hold_s, 0.0), t_now,
                          lane="sched", kind="async", parent=inv,
                          reason=reason, category=head.category,
                          hold_s=hold_s)
            tr.metrics.counter("invocations", category=head.category,
                               backend=head.backend).inc()
        t0 = time.perf_counter()
        if tr is not None:
            # lexical: backend-side spans (sharded per-device scatter /
            # gather) nest under the stage span via the tracer's stack
            with tr.span("stage", lane="host", parent=inv,
                         batch=len(chunk), tile=tile):
                outs, modeled, be = self._run_guarded(be, head, xs,
                                                      parent=inv)
            t_stage_end = tr.now()
        else:
            outs, modeled, be = self._run_guarded(be, head, xs)
        event = _record_event(outs)
        dispatch_s = time.perf_counter() - t0
        if inv is not None and be.name != head.backend:
            # graceful degradation happened: record who actually served it
            inv.annotate(served_backend=be.name)
        take = getattr(be, "take_device_samples", None)
        device_samples = take() if take is not None else None
        batch = len(chunk)
        if modeled is not None and hold_s > 0.0:
            # the modeled wall honestly prices the time this group spent
            # held open accumulating occupancy (StepCost.hold_s)
            modeled = dataclasses.replace(
                modeled, hold_s=modeled.hold_s + hold_s)
        if inv is not None and modeled is not None:
            # the decomposition the drift report joins measured spans
            # against — the exact batched_step_cost the planner priced
            inv.annotate(modeled_dac_s=modeled.dac_s,
                         modeled_adc_s=modeled.adc_s,
                         modeled_interface_s=modeled.interface_s,
                         modeled_analog_s=modeled.analog_s,
                         modeled_host_s=modeled.host_s,
                         modeled_hold_s=modeled.hold_s,
                         modeled_total_s=modeled.total_s)
        # host-like backends have no modeled price: provisional cost is the
        # staging+dispatch wall share (refined to the full measured wall at
        # retire), so ``cost`` honors the 'valid once ready' contract even
        # between flush_async and drain
        share = modeled.scaled(1.0 / batch) if modeled is not None \
            else StepCost(0.0, 0.0, 0.0, 0.0, host_s=dispatch_s / batch,
                          hold_s=hold_s / batch)
        for p, out in zip(chunk, outs):
            # async fill: the value is dispatched, not yet materialized
            p.result._fill(out, share, be.name, batch, None, event)
        shadow = (self.fidelity is not None and _shadow_worthy(be)
                  and self.fidelity.should_check(head.category))
        inflight = _Inflight(chunk=chunk, be=be, outs=outs,
                             modeled=modeled, t0=t0, dispatch_s=dispatch_s,
                             event=event, device_samples=device_samples,
                             shadow=shadow,
                             hold_s=hold_s, span=inv,
                             t_stage_end=t_stage_end, wkey=wkey)
        if shadow:
            # shadow scoring needs concrete values: validation mode is
            # synchronous by construction (batches the sample_every knob
            # skips keep the async pipeline)
            self._retire(inflight)
        else:
            self._inflight.append(inflight)

    def _retire(self, f: _Inflight) -> None:
        already_done = _is_ready(f.event)
        _block(f.event)
        now = time.perf_counter()
        if already_done:
            # deferred retirement: the computation finished while the
            # caller did unrelated host work between flush_async and
            # wait()/drain().  Wall-clock would bill that idle time to the
            # invocation (and poison the profiles replan derives); charge
            # only the host-side staging+dispatch window we observed.
            wall = f.dispatch_s
        else:
            # overlapped invocations must not double-count shared wall
            # time: charge only from where the previous retirement ended
            wall = now - max(f.t0, self._last_retire_end)
        self._last_retire_end = now
        batch = len(f.chunk)
        samples_in = sum(p.x.numel() for p in f.chunk)
        samples_out = sum(o.numel() for o in f.outs)
        bytes_in = sum(p.x.numel() * p.x.element_size() for p in f.chunk)
        bytes_out = sum(o.numel() * o.element_size() for o in f.outs)
        self.telemetry.record(
            f.chunk[0].category, f.be.name, calls=batch,
            samples_in=samples_in, samples_out=samples_out, wall_s=wall,
            modeled=f.modeled, per_device=f.device_samples,
            bytes_in=bytes_in, bytes_out=bytes_out)
        tr = self.tracer
        compute_end = 0.0
        if tr is not None and f.span is not None:
            # Charged decomposition: stage takes the host staging+dispatch
            # share of the charged wall, compute the in-flight remainder —
            # so stage + compute == wall exactly, pipeline overlap is never
            # billed twice, and per-stage sums reconcile with the flush's
            # measured wall (the export/drift contract).  Deferred
            # retirement (wall == dispatch_s) yields a zero-length compute
            # span: the device window elapsed under someone else's clock.
            stage_charged = min(f.dispatch_s, wall)
            compute_charged = max(wall - stage_charged, 0.0)
            c0 = max(f.t_stage_end, self._trace_compute_end)
            compute_end = c0 + compute_charged
            tr.record("compute", c0, compute_end, lane="device",
                      parent=f.span, backend=f.be.name,
                      charged_s=compute_charged, deferred=already_done)
            self._trace_compute_end = compute_end
            f.span.annotate(wall_s=wall, stage_s=stage_charged,
                            compute_s=compute_charged, hold_s=f.hold_s,
                            shadow_s=0.0, deferred=already_done)
            tr.metrics.histogram(
                "invocation_wall_s", category=f.chunk[0].category,
                backend=f.be.name).record(wall)
        report = None
        if f.shadow:
            t1 = time.perf_counter()
            sh = None
            if tr is not None and f.span is not None:
                sh = tr.begin("fidelity-shadow", lane="host", kind="sync",
                              parent=f.span, category=f.chunk[0].category)
            # the shadow reference is a validation probe, not workload:
            # it must neither serve from nor populate the residency cache,
            # or shadow traffic would inflate hit rates and evict operands
            # the real dispatch path still needs
            saved_res, self.ctx.residency = self.ctx.residency, None
            try:
                refs, _ = self._backend("host").run(
                    f.chunk[0].category, [p.x for p in f.chunk], self.ctx,
                    kernel=f.chunk[0].kernel, weights=f.chunk[0].weights)
                _block(_record_event(refs))
            finally:
                self.ctx.residency = saved_res
            spec = self.ctx.spec
            enob = min(spec.dac.effective_bits, spec.adc.effective_bits)
            report = self.fidelity.check(f.chunk[0].category, f.be.name,
                                         f.outs, refs, enob=enob)
            # validation overhead, not workload: keep it out of 'other'
            dt = time.perf_counter() - t1
            if sh is not None:
                tr.end(sh)
                f.span.annotate(shadow_s=dt)
            self.telemetry.discount_window(dt)
            self._last_retire_end += dt
            cat = f.chunk[0].category
            if not report.ok and f.be.name != self.retry.fallback:
                # ENOB-drift violation (a mis-ranged DAC, a drifted
                # detector): the shadow refs are already paid for, so the
                # batch is CORRECTED from them — every caller still gets
                # host-equal results — and the category is quarantined
                # through the same path retry exhaustion uses, so the
                # router's next replan and the reroute fast-path both shrink
                # around the drifting backend until probation clears it.
                ev = self.quarantine.quarantine(("category", cat),
                                                self._clock(),
                                                reason="fidelity-drift")
                self.telemetry.note_fault(cat, "drift")
                self.telemetry.note_recovery(cat, dt)
                for p, ref in zip(f.chunk, refs):
                    p.result.value = ref
                    p.result.backend = self.retry.fallback
                if tr is not None and f.span is not None:
                    tr.instant("fault", lane="sched", parent=f.span,
                               category=cat, backend=f.be.name,
                               kind="drift", rel_err=report.rel_err,
                               bound=report.bound)
                    tr.instant("fallback", lane="sched", parent=f.span,
                               category=cat, backend=f.be.name,
                               to=self.retry.fallback, reason="drift")
                    q0 = tr.now()
                    tr.record("quarantine", q0, q0 + (ev.until - ev.t),
                              lane="sched", kind="async", parent=f.span,
                              key=str(ev.key), reason=ev.reason,
                              level=ev.level)
                    tr.metrics.counter("faults", category=cat,
                                       kind="drift").inc()
                    tr.metrics.counter("quarantines",
                                       reason=ev.reason).inc()
                    tr.metrics.histogram("recovery_s",
                                         category=cat).record(dt)
        if f.modeled is None:
            # refine the provisional dispatch-only share to the measured
            # wall (the hold share survives the refinement: queueing delay
            # is real whichever backend served the release)
            measured = StepCost(0.0, 0.0, 0.0, 0.0, host_s=wall / batch,
                                hold_s=f.hold_s / batch)
            for p in f.chunk:
                p.result.cost = measured
        if report is not None:
            for p in f.chunk:
                p.result.fidelity = report
        if tr is not None and f.span is not None:
            # the invocation container closes at retirement, covering its
            # children (the charged compute window may extend past now
            # when clocks mix — containment wins)
            tr.end(f.span, max(tr.now(), compute_end))
