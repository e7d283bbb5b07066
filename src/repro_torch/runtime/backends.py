"""Backend registry: three interchangeable executors per op category.

Every backend implements the same three op categories the planner knows
about (``fft``, ``conv``, ``matmul``) with identical call signatures, so
the executor can swap them per the routing table without touching callers:

  ``host``        pure digital PyTorch (fft2 / circular conv / matmul) —
                  the baseline the planner's ``host_s`` measures.
  ``optical-sim`` the simulated analog engine with the conversion boundary
                  applied: the fused DFT pipeline (DAC quantization folded
                  into stage 1, square-law detector into stage 2 — two
                  hand-written CUDA kernels on the card, their plain
                  versions on the CPU) plus the auto-ranged ADC read path
                  for ``fft``; the 4f physics simulator for ``conv``;
                  DAC->MVM->ADC for ``matmul``.  Returns a modeled
                  :class:`StepCost` built from the executor's accelerator
                  spec so every result is priced, not just produced.
  ``ideal``       the zero-conversion-cost analog bound (paper Table 1):
                  exact digital values, cost = analog physics only.

Op semantics (fixed across backends so results are comparable):

  fft(a)        -> detector intensity |F a|^2 of the unitary 2-D DFT,
                   a real, values in [0, 1] (the camera cannot see phase;
                   a single capture yields intensity — paper App. A.1).
  conv(a, k)    -> circular 2-D convolution (4-step interferometric capture
                   + host-side inverse transform, paper Eq. 1).
  matmul(a, w)  -> a @ w with activations streamed through the converters
                   (weights held in the optical domain, amortized).

Batching is *real* on every backend: ``run`` stacks the group's same-shape
items into one ``(K, H, W)`` tensor and makes ONE batched invocation — one
batched ``fft2``/conv/matmul on the host, the two batched DFT kernels
(factor matrices shared across frames) or the batched 4f/MVM simulation on
the analog backends.  Per-item semantics are preserved inside the batch
(per-frame ADC auto-ranging, per-item affine range mapping, per-item
matmul scaling), so batched results match a Python loop of single-item
calls to float tolerance.
"""

from __future__ import annotations

import abc
import dataclasses
import hashlib
import math
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.accelerator import (
    OpticalFourierAcceleratorSpec,
    OpticalMVMAcceleratorSpec,
    StepCost,
)
from repro_torch.core.optical import (
    OpticalSimParams,
    adc_quantize_batched,
    dac_quantize,
    fourier_mask_for_kernel,
    optical_conv2d_batched,
)
from repro_torch.kernels.optical_dft import (
    dft_matrix_factors,
    dft_stage1_batched,
    dft_stage2_batched,
)
from repro_torch.runtime.residency import residency_key
from repro_torch.runtime.tiling import BlockPlan, MemoryBudget, choose_blocks

__all__ = [
    "CATEGORIES",
    "CONV_CAPTURES",
    "BackendContext",
    "ExecutionBackend",
    "HostBackend",
    "OpticalSimBackend",
    "IdealBackend",
    "conv_range_map",
    "ideal_step_cost",
    "register_backend",
    "get_backend",
    "available_backends",
    "stage_group",
]

CATEGORIES = ("fft", "conv", "matmul")

# Interferometric complex recovery (needed by conv) costs 4 captures.
CONV_CAPTURES = 4

# Bound on the digest memo: operands worth memoizing (kernels, weights,
# reused frames) are few.
_DIGEST_MEMO_MAX = 64


@dataclasses.dataclass
class BackendContext:
    """Per-executor state shared with backends: the accelerator spec, the
    device every operand lives on, and the shape-keyed caches (DFT factor
    matrices, Fourier-plane masks, resolved block plans).

    ``pipeline_depth`` is how deep the owning executor overlaps boundary
    crossings for *this* invocation; analog backends thread it into
    ``batched_step_cost`` so the modeled price matches how the invocation
    is actually overlapped (2 = the executor's async double-buffered
    flush; 1 = strictly serial crossings).  The executor writes it
    per-dispatch (and ``warm()`` mirrors the same write) from the
    dispatched category's per-engine pipeline window.

    ``n_devices`` is how many replicated simulated accelerators the sharded
    backend scatters one invocation across (the executor writes the
    per-category effective count here before every dispatch — and before
    ``warm`` — so sharded dispatch shapes are primed consistently);
    ``shard_mode`` picks between group sharding, frame sharding, and the
    automatic policy (see ``repro_torch.runtime.sharded``).

    ``mem_budget`` is the staging byte budget
    (``repro_torch.runtime.tiling.MemoryBudget``): the executor tiles
    flush groups against it, and the optical backend resolves the DFT
    stages' block plan from it (``blocks_for``)."""

    spec: OpticalFourierAcceleratorSpec | OpticalMVMAcceleratorSpec
    device: torch.device = dataclasses.field(
        default_factory=lambda: torch.device("cpu"))
    factor_cache: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default_factory=dict)
    mask_cache: dict[tuple, torch.Tensor] = \
        dataclasses.field(default_factory=dict)
    pipeline_depth: int = 2
    n_devices: int = 1
    shard_mode: str = "auto"
    mem_budget: "MemoryBudget | None" = None
    block_cache: dict[tuple, "BlockPlan"] = \
        dataclasses.field(default_factory=dict)
    # id -> (operand, its _version when hashed, content key)
    _digest_memo: dict[int, tuple] = dataclasses.field(default_factory=dict)
    # The owning executor's tracer (None = tracing off).  The residency
    # cache emits ``cache`` instants through it, and the sharded backend
    # its per-device scatter/gather spans, which nest under the
    # executor's stage span via the tracer's lexical stack.
    tracer: "object | None" = None
    # The owning executor's timebase (``ManualClock`` in deterministic
    # tests/benches, ``time.perf_counter`` live).  Fault-aware backends
    # sleep injected straggles and stamp quarantine windows through it so
    # the whole fault story replays bit-identically under a manual clock.
    clock: "Callable[[], float]" = time.perf_counter
    # Devices declared lost for the *current* dispatch only (chaos
    # injection): the sharded backend's shard on a lost device raises
    # DeviceLostError and recovers on a survivor.  Cleared by the injector.
    lost_devices: frozenset = frozenset()
    # Fault-handling collaborators (duck-typed like ``tracer`` to keep
    # backends importable without the faults/telemetry modules): the
    # executor's Quarantine (sharded dispatch skips quarantined devices and
    # records new exclusions here) and its DispatchWatchdog (per-device
    # straggler deadlines).
    quarantine: "object | None" = None
    watchdog: "object | None" = None
    # The owning executor's RuntimeTelemetry (residency/delta/fault
    # counters).
    telemetry: "object | None" = None
    # The owning executor's operand residency cache
    # (``repro_torch.runtime.residency.ResidencyCache``), or None for the
    # stage-every-flush behavior.
    residency: "object | None" = None
    # Which physical write stream ``stage_group`` is staging into: "host"
    # for the staged-stack path, ("device", d) when the sharded backend
    # runs the inner backend against one device's sub-group.  Delta
    # classification keys its per-slot code signatures by this, so two
    # devices' same-shaped sub-groups never diff against each other's
    # staged codes.
    stage_stream: "object" = "host"

    def blocks_for(self, batch: int, h: int, w: int) -> "BlockPlan":
        """Resolved block plan for a ``(batch, h, w)`` stacked DFT
        invocation, derived from the budget (``choose_blocks``).  Keyed by
        the stack shape AND the budget, so a replanned tile depth or a
        swapped budget always resolves afresh."""
        budget = self.mem_budget
        key = (batch, h, w,
               None if budget is None else (budget.bytes_limit,
                                            budget.reserve))
        if key not in self.block_cache:
            self.block_cache[key] = choose_blocks(batch, h, w, w, budget)
        return self.block_cache[key]

    def factors(self, n: int, blocks: tuple = (),
                device: torch.device | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The unitary DFT factors of size ``n`` on ``device`` (the
        context's by default).  The key carries the block plan they are
        used under, as the reference's does; the values depend only on n,
        so every layout entry aliases one shared pair.  A shard placed on
        another card gets its own pair there, keyed by that device, so no
        kernel is handed factors that live on a different card."""
        dev = () if device is None or device == self.device \
            else (str(device),)
        key = (n,) + tuple(blocks) + dev
        if key not in self.factor_cache:
            base = self.factor_cache.get((n,) + dev)
            if base is None:
                base = dft_matrix_factors(n, device=device or self.device)
                self.factor_cache[(n,) + dev] = base
            self.factor_cache[key] = base
        return self.factor_cache[key]

    def content_key(self, x) -> tuple:
        """Content key of an operand: shape, dtype, SHA1 of the bytes.

        Content-keyed (not id-keyed): object identity can be recycled by
        the allocator after a temporary dies, which would serve a stale
        cache entry.  Repeat hashing of a long-lived operand is avoided by
        an id-keyed memo that HOLDS a reference to it (so a recycled id
        cannot alias while the entry lives) and records the tensor's
        ``_version``: torch tensors are mutable, every in-place write bumps
        the version, and a memo entry whose version moved is re-hashed.
        A tensor on the card costs a copy to the host and a sync to hash.
        Writeable numpy buffers carry no version and are never memoized."""
        version = getattr(x, "_version", None)
        memo = self._digest_memo.get(id(x))
        if memo is not None and memo[0] is x and memo[1] == version:
            return memo[2]
        if isinstance(x, torch.Tensor):
            arr = x.detach().cpu().numpy()
            dtype = str(x.dtype)
        else:
            arr = np.asarray(x)
            dtype = str(arr.dtype)
        key = (tuple(arr.shape), dtype,
               hashlib.sha1(arr.tobytes()).hexdigest())
        if version is None and getattr(getattr(x, "flags", None),
                                       "writeable", False):
            return key
        if len(self._digest_memo) >= _DIGEST_MEMO_MAX:
            self._digest_memo.clear()
        self._digest_memo[id(x)] = (x, version, key)
        return key

    def mask(self, kernel: torch.Tensor) -> torch.Tensor:
        """The Fourier-plane mask of ``kernel``, cached by content and
        device (a mask lives where its kernel lives)."""
        key = self.content_key(kernel) + (str(kernel.device),)
        if key not in self.mask_cache:
            self.mask_cache[key] = fourier_mask_for_kernel(kernel)
        return self.mask_cache[key]

    @property
    def sim_params(self) -> OpticalSimParams:
        return OpticalSimParams(dac_bits=self.spec.dac.bits,
                                adc_bits=self.spec.adc.bits)


class ExecutionBackend(abc.ABC):
    """One way of executing the planner's op categories."""

    name: str = "?"

    def supports(self, category: str, ctx: BackendContext) -> bool:
        if category not in CATEGORIES:
            return False
        if category == "matmul":
            return isinstance(ctx.spec, OpticalMVMAcceleratorSpec) \
                or self.name == "host"
        return isinstance(ctx.spec, OpticalFourierAcceleratorSpec) \
            or self.name == "host"

    @abc.abstractmethod
    def run(self, category: str, xs: Sequence[torch.Tensor],
            ctx: BackendContext, *, kernel: torch.Tensor | None = None,
            weights: torch.Tensor | None = None,
            ) -> tuple[list[torch.Tensor], StepCost | None]:
        """Execute a batch of same-shape requests.

        Returns per-item results and the modeled cost of the whole batch
        (None for backends whose cost is just their measured wall time)."""


def _samples(x: torch.Tensor) -> int:
    return int(x.numel())


def stage_group(category: str, xs: Sequence[torch.Tensor],
                ctx: BackendContext, *, single_expand: bool = False,
                ) -> tuple[torch.Tensor, int, tuple]:
    """Stack a same-shape group into the dispatch operand, serving the
    staged stack from the context's residency cache on a content hit.

    Returns ``(stack, resident, delta_fractions)``: ``resident`` is how
    many of the group's items were already staged (``len(xs)`` on a
    group-grain hit), and ``delta_fractions`` the per-frame write scales
    of the items that changed *little enough* to take the delta-encoded
    partial write.  On a group miss each frame is classified against the
    operand last staged into its dispatch slot (the host write stream +
    category + shape + position, via
    ``ResidencyCache.classify_operand``; the write stream is the context's
    ``stage_stream``).  With no cache attached this is exactly
    ``torch.stack`` (or the host's single-item expand).  A cached stack
    that lives on another device than the group (a shard placed on
    another card) is a miss.
    """
    res = ctx.residency
    if res is None:
        if single_expand and len(xs) == 1:
            return xs[0].unsqueeze(0), 0, ()
        return torch.stack(list(xs)), 0, ()
    key = residency_key(ctx, xs, "frame")
    stack = res.lookup("host", key, category=category, ctx=ctx)
    if stack is not None and stack.device == xs[0].device:
        return stack, len(xs), ()
    if single_expand and len(xs) == 1:
        stack = xs[0].unsqueeze(0)
    else:
        stack = torch.stack(list(xs))
    res.store("host", key, stack, stack.numel() * stack.element_size(),
              category=category, kind="frame", ctx=ctx)
    # group-grain miss: classify each frame against its dispatch slot —
    # unchanged frames are still resident per-frame, drifted ones delta
    shape_sig = (tuple(xs[0].shape), str(xs[0].dtype))
    op = key[1]
    resident = 0
    deltas: list[float] = []
    stream = ctx.stage_stream
    for i, ck in enumerate(key[2]):
        slot = (stream, category, "frame", op, shape_sig, i)
        label, scale = res.classify_operand(slot, ck, xs[i], ctx.spec,
                                            category=category, ctx=ctx)
        if label == "hit":
            resident += 1
        elif label == "delta":
            deltas.append(scale)
    return stack, resident, tuple(deltas)


def _operand_resident(category: str, arr: torch.Tensor | None,
                      ctx: BackendContext, kind: str) -> bool:
    """Whether a kernel/weight operand is resident (registering it when
    not): True means this invocation writes no weight samples."""
    res = ctx.residency
    if res is None or arr is None:
        return False
    key = residency_key(ctx, [arr], kind)
    if res.lookup("host", key, category=category, ctx=ctx) is not None:
        return True
    res.store("host", key, arr, arr.numel() * arr.element_size(),
              category=category, kind=kind, ctx=ctx)
    return False


# --- host: the digital baseline ----------------------------------------------

# Each op accepts a leading batch axis natively: fft2/ifft2 act on the last
# two axes (the (H, W) kernel broadcasts under the (K, H, W) stack) and
# (K, m, k) @ (k, n) is a batched matmul.  One call serves the group.


def _host_fft_intensity(a: torch.Tensor) -> torch.Tensor:
    return torch.fft.fft2(a, norm="ortho").abs() ** 2


def _host_circular_conv(a: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.fft.ifft2(torch.fft.fft2(a) * torch.fft.fft2(k)).real


def _host_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return a @ w


class HostBackend(ExecutionBackend):
    """Pure PyTorch execution; cost is whatever wall time the executor
    measures."""

    name = "host"

    def run(self, category, xs, ctx, *, kernel=None, weights=None):
        stack, _, _ = stage_group(category, xs, ctx, single_expand=True)
        if category == "fft":
            out = _host_fft_intensity(stack)
        elif category == "conv":
            out = _host_circular_conv(stack, kernel)
        elif category == "matmul":
            out = _host_matmul(stack, weights)
        else:
            raise ValueError(f"unknown category {category!r}")
        return list(out), None


# --- optical-sim: the conversion boundary, executed and priced ----------------


def conv_range_map(stack: torch.Tensor,
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-frame affine map of arbitrary-range frames onto the SLM's [0, 1]
    aperture: the DAC's full-scale range is fixed and the SLM cannot encode
    negative amplitudes.  Conv is linear, so the map undoes exactly:
    conv(s*v + lo) = s*conv(v) + lo*sum(kernel) (circular conv of a
    constant plane is the kernel sum).  Shared by the batched conv path and
    the frame-sharded tiler — the two must use the SAME map (one grid of
    DAC quantization points) or sharded results drift from unsharded ones.
    """
    lo = torch.amin(stack, dim=(-2, -1), keepdim=True)
    hi = torch.amax(stack, dim=(-2, -1), keepdim=True)
    return lo, torch.clamp(hi - lo, min=1e-9)


def _optical_conv_batched(stack: torch.Tensor, mask: torch.Tensor,
                          ksum: torch.Tensor,
                          params: OpticalSimParams) -> torch.Tensor:
    # lo/scale are per frame, and ``optical_conv2d_batched`` keeps the
    # interferometric ADC full-scale per frame too.
    lo, scale = conv_range_map(stack)
    v = (stack - lo) / scale
    out = optical_conv2d_batched(v, mask, params, None)
    return out * scale + lo * ksum


def _optical_matmul_batched(stack: torch.Tensor, w: torch.Tensor, *,
                            dac_bits: int, adc_bits: int) -> torch.Tensor:
    # One streamed invocation: the batch stacks activation rows, but each
    # item keeps its own DAC range mapping and differential ADC ranges.
    scale = torch.clamp(torch.amax(stack.abs(), dim=(1, 2), keepdim=True),
                        min=1e-9)
    q = dac_quantize(0.5 * (stack / scale + 1.0), dac_bits) * 2.0 - 1.0
    y = (q * scale) @ w
    pos = torch.clamp(y, min=0.0)
    neg = torch.clamp(-y, min=0.0)  # differential readout: two ADC ranges
    return (adc_quantize_batched(pos, adc_bits)
            - adc_quantize_batched(neg, adc_bits))


class OpticalSimBackend(ExecutionBackend):
    """Simulated analog engine with DAC/ADC quantization applied.

    Every category executes the whole group in ONE batched invocation:
    ``fft`` runs the batched DFT pipeline (``dft_stage1_batched`` /
    ``dft_stage2_batched`` — the CUDA kernels for a stack on the card,
    their plain versions for a stack on the CPU; cached factor matrices
    shared across frames) then a per-frame auto-ranged ADC pass; ``conv``
    runs the batched 4f physics simulator; ``matmul`` streams the stacked
    activations through the converter models around one batched matmul
    standing in for the MVM core.  Every batch returns a
    :class:`StepCost` from the spec's ``batched_step_cost`` at the
    context's pipeline depth.
    """

    name = "optical-sim"

    def _fft_batched(self, stack: torch.Tensor,
                     ctx: BackendContext) -> torch.Tensor:
        batch, h, w = stack.shape
        # the block plan comes from the budget, as in the reference; the
        # kernels validate it and tile with their own compile-time blocks
        plan = ctx.blocks_for(batch, h, w)
        whr, whi = ctx.factors(h, plan.key, stack.device)
        wwr, wwi = ctx.factors(w, plan.key, stack.device)
        tr, ti = dft_stage1_batched(whr, whi, stack,
                                    dac_bits=ctx.spec.dac.bits,
                                    bb=plan.bb, bm=plan.bm,
                                    bk=plan.bk, bn=plan.bn)
        intensity = dft_stage2_batched(tr, ti, wwr, wwi, bb=plan.bb,
                                       bm=plan.bm, bk=plan.bk, bn=plan.bn)
        return adc_quantize_batched(intensity, ctx.spec.adc.bits)

    def run(self, category, xs, ctx, *, kernel=None, weights=None):
        batch = len(xs)
        n_in = _samples(xs[0])
        stack, resident, deltas = stage_group(category, xs, ctx)
        depth = ctx.pipeline_depth
        priced_residency = ctx.residency is not None
        if category == "fft":
            out = self._fft_batched(stack, ctx)
            cost = ctx.spec.batched_step_cost(n_in, _samples(out[0]),
                                              batch=batch,
                                              pipeline_depth=depth,
                                              resident_frames=resident,
                                              delta_fractions=deltas)
        elif category == "conv":
            mask = ctx.mask(kernel)
            # registered before the mask build so a repeat kernel prices as
            # resident even though ctx.mask memoizes the mask either way
            k_resident = _operand_resident(category, kernel, ctx, "kernel")
            out = _optical_conv_batched(stack, mask, torch.sum(kernel),
                                        ctx.sim_params)
            spec4 = dataclasses.replace(ctx.spec,
                                        phase_shift_captures=CONV_CAPTURES)
            k_n = _samples(kernel) if priced_residency else 0
            cost = spec4.batched_step_cost(
                n_in, _samples(out[0]), batch=batch, pipeline_depth=depth,
                resident_frames=resident, weight_samples=k_n,
                resident_weights=k_n if k_resident else 0,
                delta_fractions=deltas)
        elif category == "matmul":
            w_resident = _operand_resident(category, weights, ctx, "weights")
            out = _optical_matmul_batched(stack, weights,
                                          dac_bits=ctx.spec.dac.bits,
                                          adc_bits=ctx.spec.adc.bits)
            m, k = xs[0].shape
            n = weights.shape[-1]
            # Batching stacks activations along m: one streamed invocation.
            # With residency priced, a non-resident weight panel charges
            # its one-time DAC load (weight_write) and fully resident
            # activations drop the streaming DAC term: hits read-side-only.
            w_write = priced_residency and not w_resident
            cost = ctx.spec.matmul_cost(batch * m, k, n,
                                        weight_write=w_write)
            if resident >= batch:
                act_free = ctx.spec.dac.time_for(k * n, ctx.spec.dac_lanes) \
                    if w_write else 0.0
                cost = dataclasses.replace(cost, dac_s=act_free)
            elif deltas:
                # delta-staged activations: resident frames free, delta
                # frames at their write scale, the rest whole
                written = batch - resident
                ws = (math.fsum(deltas) + (written - len(deltas))) / written
                col_tiles = math.ceil(n / ctx.spec.cols)
                w_dac = ctx.spec.dac.time_for(k * n, ctx.spec.dac_lanes) \
                    if w_write else 0.0
                act_dac = ctx.spec.dac.time_for(
                    written * m * k * col_tiles, ctx.spec.dac_lanes) * ws
                cost = dataclasses.replace(cost, dac_s=w_dac + act_dac)
            cost = dataclasses.replace(
                cost, interface_s=ctx.spec.interface_latency_s)
        else:
            raise ValueError(f"unknown category {category!r}")
        return list(out), cost


# --- ideal: the zero-conversion-cost analog bound -----------------------------


def ideal_step_cost(spec, category: str, calls: int) -> StepCost:
    """The zero-conversion analog bound for one invocation: physics only.

    Shared by :class:`IdealBackend` and the sharded tiler's per-device
    pricing so the Table-1 bound has exactly one definition."""
    if isinstance(spec, OpticalMVMAcceleratorSpec):
        analog = calls * spec.optical_pass_s
    else:
        caps = CONV_CAPTURES if category == "conv" \
            else spec.phase_shift_captures
        analog = ((spec.slm_settle_s + spec.exposure_s) * caps
                  + spec.time_of_flight_s())
    return StepCost(0.0, 0.0, 0.0, analog_s=analog)


class IdealBackend(ExecutionBackend):
    """Exact digital values, priced as if conversion and interface were free.

    This is the paper's Table-1 'ideal accelerator' column made executable:
    the only cost charged is the analog physics itself, so comparing a plan
    under ``ideal`` against ``optical-sim`` isolates exactly what the
    boundary costs.
    """

    name = "ideal"

    def run(self, category, xs, ctx, *, kernel=None, weights=None):
        outs, _ = _HOST.run(category, xs, ctx, kernel=kernel, weights=weights)
        return outs, ideal_step_cost(ctx.spec, category, len(xs))


_HOST = HostBackend()

_REGISTRY: dict[str, Callable[[], ExecutionBackend]] = {}


def register_backend(name: str,
                     factory: Callable[[], ExecutionBackend]) -> None:
    """Register (or override) a backend under ``name``."""
    _REGISTRY[name] = factory


def get_backend(name: str) -> ExecutionBackend:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown backend {name!r}; "
                       f"available: {available_backends()}") from None


def available_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_backend("host", HostBackend)
register_backend("optical-sim", OpticalSimBackend)
register_backend("ideal", IdealBackend)
