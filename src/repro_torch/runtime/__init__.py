"""Conversion-aware offload runtime (PyTorch port): execute hybrid
host/optical plans on the CUDA card.

Module map (each mirrors its counterpart in ``repro.runtime``):

  backends   — registry of three interchangeable executors per op category:
               ``host`` (pure PyTorch fft/conv/matmul), ``optical-sim``
               (the fused DFT pipeline — two hand-written CUDA kernels on
               the card — plus the 4f physics sim with the DAC/ADC boundary
               applied, every batch priced with a ``StepCost``), ``ideal``
               (exact values at the zero-conversion analog bound).
  executor   — ``OffloadExecutor``: request queue that coalesces same-shape
               calls into ONE batched invocation, pipelined two deep per
               ``(category, backend)`` window (``flush_async``; readiness
               through a ``torch.cuda.Event`` recorded after each
               dispatch), tiled against the memory budget, with retry /
               fallback / quarantine and opt-in operand residency.  Runs
               on the CUDA card unless built with ``device="cpu"``.
  sharded    — ``ShardedOpticalBackend`` (``sharded`` / ``sharded-host`` /
               ``sharded-ideal``): one invocation scattered over
               ``n_devices`` simulated accelerators, by frame groups or by
               overlap-save row tiles, priced max-over-devices.  One CUDA
               card per shard when the machine has enough
               (``distributed.sharding.shard_devices``); on one card or on
               the CPU the shards run in turn on the executor's device
               with identical numerics.
  telemetry  — ``RuntimeTelemetry``: measured per-category traffic emitted
               as ``CategoryProfile``s so ``plan_offload`` re-plans from it.
  fidelity   — ``FidelityChecker``: shadows optical-sim batches with the
               host reference and scores them against the ENOB budget.
  tiling     — ``MemoryBudget`` (L2-derived on CUDA, LLC-derived on the
               CPU) / ``choose_tile`` / ``choose_blocks``.
  residency  — ``ResidencyCache``: content-keyed operand residency.
  scheduler  — ``OffloadScheduler``: admission-controlled continuous
               batching over the executor (hold partially filled groups
               across flushes; release when full, due or futile);
               ``ManualClock`` makes admission deterministic in tests.
  router     — ``PlanRouter``: applies an ``OffloadPlan`` and closes the
               profile -> plan -> execute -> re-profile loop.
  faults     — fault injection (``FaultSchedule``, ``ChaosBackend``,
               ``register_chaos``: seeded errors, straggles, drift and
               device loss, deterministic under a ``ManualClock``) and
               handling (``RetryPolicy``, ``DispatchWatchdog``,
               ``Quarantine``).
  tracing / metrics — opt-in span tracer, percentile metrics, drift report.
  trace_export — Chrome/Perfetto ``trace_event`` JSON (``write_trace``),
               one lane per device under sharded dispatch, and
               ``reconcile`` (charged stage sums against a flush's wall).
  specs      — shared demo design points (``BATCHED_4F``).

The sharded, chaos and trace paths run the same on the CPU
(``device="cpu"``) and on the card::

    ex = OffloadExecutor(BATCHED_4F, n_devices=4,
                         default_backend="sharded", tracer=Tracer())
    name = register_chaos("sharded", rate=0.3, seed=0)  # a chaos backend
    ...
    write_trace("flush.json", ex.tracer.spans())        # open in Perfetto

Quick start::

    from repro_torch.runtime import OffloadExecutor, PlanRouter
    ex = OffloadExecutor(BATCHED_4F, max_batch=16)   # on the CUDA card
    router = PlanRouter(ex)                   # all-host profiling mode
    ex.telemetry.start()
    outs = [router.run("fft", img) for img in imgs]
    ex.telemetry.stop()
    plan = router.replan()                    # measured plan; routes updated
"""

from repro_torch.runtime.backends import (
    CATEGORIES,
    CONV_CAPTURES,
    BackendContext,
    ExecutionBackend,
    HostBackend,
    IdealBackend,
    OpticalSimBackend,
    available_backends,
    get_backend,
    register_backend,
)
from repro_torch.runtime.executor import OffloadExecutor, OffloadResult
from repro_torch.runtime.faults import (
    ChaosBackend,
    DeviceLostError,
    DispatchWatchdog,
    Fault,
    FaultError,
    FaultSchedule,
    Quarantine,
    QuarantineEvent,
    RetryPolicy,
    TransientDispatchError,
    advance_or_sleep,
    register_chaos,
)
from repro_torch.runtime.fidelity import (FidelityChecker, FidelityReport,
                                          enob_error_bound)
from repro_torch.runtime.metrics import (
    Counter,
    DriftReport,
    Histogram,
    MetricsRegistry,
    StageDrift,
    drift_report,
)
from repro_torch.runtime.residency import (
    DELTA_THRESHOLD,
    ResidencyCache,
    ResidencyEntry,
    operating_point,
    residency_key,
)
from repro_torch.runtime.router import PlanRouter
from repro_torch.runtime.scheduler import ManualClock, OffloadScheduler
from repro_torch.runtime.sharded import (ShardedOpticalBackend, kernel_halo,
                                         shard_sizes)
from repro_torch.runtime.specs import BATCHED_4F, CAMERA_ADC, SLM_DAC
from repro_torch.runtime.telemetry import (
    BackendStats,
    DeltaStats,
    DeviceStats,
    RuntimeTelemetry,
    WindowStats,
)
from repro_torch.runtime.tiling import (
    BlockPlan,
    MemoryBudget,
    TilePlan,
    choose_blocks,
    choose_tile,
    tile_sizes,
)
from repro_torch.runtime.trace_export import (
    reconcile,
    stage_sums,
    summarize,
    to_trace_events,
    write_trace,
)
from repro_torch.runtime.tracing import Span, Tracer

__all__ = [
    "CATEGORIES",
    "CONV_CAPTURES",
    "BackendContext",
    "ExecutionBackend",
    "HostBackend",
    "IdealBackend",
    "OpticalSimBackend",
    "available_backends",
    "get_backend",
    "register_backend",
    "OffloadExecutor",
    "OffloadResult",
    "ChaosBackend",
    "DeviceLostError",
    "DispatchWatchdog",
    "Fault",
    "FaultError",
    "FaultSchedule",
    "Quarantine",
    "QuarantineEvent",
    "RetryPolicy",
    "TransientDispatchError",
    "advance_or_sleep",
    "register_chaos",
    "FidelityChecker",
    "FidelityReport",
    "enob_error_bound",
    "Counter",
    "DriftReport",
    "Histogram",
    "MetricsRegistry",
    "StageDrift",
    "drift_report",
    "DELTA_THRESHOLD",
    "ResidencyCache",
    "ResidencyEntry",
    "operating_point",
    "residency_key",
    "PlanRouter",
    "ManualClock",
    "OffloadScheduler",
    "ShardedOpticalBackend",
    "kernel_halo",
    "shard_sizes",
    "BATCHED_4F",
    "CAMERA_ADC",
    "SLM_DAC",
    "BackendStats",
    "DeltaStats",
    "DeviceStats",
    "RuntimeTelemetry",
    "WindowStats",
    "BlockPlan",
    "MemoryBudget",
    "TilePlan",
    "choose_blocks",
    "choose_tile",
    "tile_sizes",
    "Span",
    "Tracer",
    "reconcile",
    "stage_sums",
    "summarize",
    "to_trace_events",
    "write_trace",
]
