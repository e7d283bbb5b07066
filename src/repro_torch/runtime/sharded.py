"""Multi-device sharded offload: scatter one invocation across accelerators.

Photonic systems scale by *replicating apertures*, not by growing one (a
bigger SLM needs a bigger lens, a longer path, and a denser camera; a second
4f engine needs none of that).  This module makes that scaling mode
executable: :class:`ShardedOpticalBackend` wraps any registered inner
backend (``host`` / ``optical-sim`` / ``ideal``) and splits each batched
invocation across ``ctx.n_devices`` simulated accelerators, two ways:

  group sharding   the stacked ``(K, H, W)`` flush group scatters across
                   devices — device d carries a contiguous slice of the
                   batch through its OWN converters, so every device pays
                   its own DAC/ADC boundary crossing (per-invocation fixed
                   costs do NOT amortize across devices) but the crossings
                   run concurrently: the modeled wall is max-over-devices
                   plus a per-device sync epsilon
                   (``batched_step_cost(n_devices=...)``).
  frame sharding   one large frame tiles onto multiple apertures.  ``conv``
                   uses overlap-save: each device receives its row block
                   plus a circular halo covering the kernel's support, runs
                   the 4f pipeline on the extended tile, and discards the
                   halo rows — exact up to per-device converter
                   quantization (each aperture's detector auto-exposes its
                   own tile, precisely the "every device pays its own
                   boundary" story).  ``matmul`` row-splits the activation
                   block (no halo needed — rows are independent).  ``fft``
                   never frame-shards: the 2-D DFT is global, so tiling
                   would need a cross-device transpose between the two 1-D
                   stages — it group-shards instead.

Placement: :func:`repro_torch.distributed.sharding.shard_devices` hands
out one CUDA card per shard when the executor runs on a card and the
machine has enough of them.  Each shard's frames are copied to its card
(``Tensor.to``), the kernel or weights follow them once per card (cached),
the inner backend launches there (the DFT wrappers launch on their
operands' device), and the outputs come back to the executor's device.
CUDA launches return before the work is done, so the shards run
concurrently.  With fewer cards than shards (one card, or the CPU) the
same shards dispatch in turn on the executor's device with identical
numerics — the reference's off-mesh fallback, which the equivalence
tests lock down: sharded == single-device batched == looped per-frame,
on every backend.

Per-device boundary traffic is surfaced to the executor via
:meth:`ShardedOpticalBackend.take_device_samples` and aggregated by
:class:`~repro_torch.runtime.telemetry.RuntimeTelemetry`.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch.core.accelerator import StepCost
from repro_torch.core.optical import optical_conv2d_batched
from repro_torch.distributed.sharding import shard_devices
from repro_torch.runtime.backends import (
    CONV_CAPTURES,
    BackendContext,
    ExecutionBackend,
    _host_circular_conv,
    _host_matmul,
    _optical_matmul_batched,
    conv_range_map,
    get_backend,
    ideal_step_cost,
    register_backend,
)
from repro_torch.runtime.faults import DeviceLostError, FaultError
from repro_torch.runtime.residency import operating_point, residency_key

__all__ = ["ShardedOpticalBackend", "shard_sizes", "kernel_halo"]

# Bound on each per-backend cache of kernel-derived host data (halos,
# folded kernels, operands copied to a shard's card): kernels are few.
_CACHE_MAX = 64


@dataclasses.dataclass
class _Placement:
    """One committed sharded placement for a (category, group-shape).

    ``assign`` maps each frame's content key to the pool slot whose device
    holds it resident; the mapping replicates the executor's exact
    dispatch structure (per-tile ``shard_sizes`` split over the survivor
    pool), so a placed tile dispatches the same per-device stack shapes
    the re-scatter path runs — warm parity by construction.  The
    placement outlives tiles AND flushes: frames stay device-resident in
    the ``ResidencyCache``'s per-device sets until their content changes
    (only changed frames re-cross the DAC) or a device quarantines (the
    placement drops and the next commit rebuilds on survivors)."""

    pool: list[int]                 # logical device slots (survivors)
    devices: list | None            # torch devices (None: sequential)
    assign: dict[tuple, int]        # frame content key -> pool slot
    frames: int = 0                 # frames covered at commit time


# Inners frame sharding knows how to drive (group sharding takes any inner).
_FRAME_INNERS = ("host", "optical-sim", "ideal")


def _device_span(ctx, d: int, frames: int):
    """Span over one device's host-side scatter staging (copy + inner
    dispatch) when the owning executor traces; no-op otherwise.  The
    per-device loop runs on the host sequentially, so its spans sum to the
    serial staging cost the modeled max-over-devices wall never pays."""
    tr = ctx.tracer
    if tr is None:
        return contextlib.nullcontext()
    return tr.span("scatter", lane=f"device{d}", device=d, frames=frames)


def _stage_span(ctx, d: int, frames: int):
    """Span over JUST the host->device staging work for one shard (the
    copy + residency bookkeeping inside the broader ``scatter`` span,
    compute launch excluded).  Summed per flush this is the re-scatter tax
    a committed placement eliminates: on a resident hit the span closes in
    microseconds because nothing crosses."""
    tr = ctx.tracer
    if tr is None:
        return contextlib.nullcontext()
    return tr.span("scatter_stage", lane=f"device{d}", device=d,
                   frames=frames)


def _gather_span(ctx, n_blocks: int):
    """Span over the host-side gather + reassembly of per-device blocks."""
    tr = ctx.tracer
    if tr is None:
        return contextlib.nullcontext()
    return tr.span("gather", lane="host", blocks=n_blocks)


def shard_sizes(total: int, n: int) -> list[int]:
    """Balanced contiguous shard sizes over ``n`` devices.

    The first ``total % n`` shards carry one extra item, so ``max(sizes) ==
    ceil(total / n)`` — exactly the largest-shard crossing the cost model's
    max-over-devices pricing charges.  Never returns more shards than
    items (``n`` is clamped), so a 3-deep group on 4 devices uses 3.
    """
    n = max(1, min(n, total))
    base, rem = divmod(total, n)
    return [base + (1 if i < rem else 0) for i in range(n)]


def _host_rows(kernel) -> tuple[np.ndarray, np.ndarray]:
    """The kernel on the host and the indices of its nonzero rows."""
    if isinstance(kernel, torch.Tensor):
        kernel = kernel.detach().cpu().numpy()
    k = np.asarray(kernel)
    return k, np.nonzero(np.any(k != 0, axis=-1))[0]


def kernel_halo(kernel) -> tuple[int, int]:
    """(halo_top, halo_bottom) rows a conv tile needs for overlap-save.

    Circular conv: ``out[i] = sum_r k[r] * a[(i - r) mod H]``.  A kernel row
    ``r`` is read as the circular offset ``r`` (if ``r <= H/2``) or ``r - H``
    (wrap-around support, e.g. the bottom rows of a centered kernel):
    positive offsets pull input rows *above* the tile, negative ones below.
    Reads the kernel on the host: the backend caches the result by the
    kernel's content key, so a repeat flush reads nothing back.
    """
    k, rows = _host_rows(kernel)
    if rows.size == 0:
        return 0, 0
    h = k.shape[-2]
    off = np.where(rows <= h // 2, rows, rows - h)
    return int(max(off.max(), 0)), int(max(-off.min(), 0))


def _gather_blocks(blocks: list[torch.Tensor], devices,
                   ctx: BackendContext) -> list[torch.Tensor]:
    """Bring per-device output blocks back onto the executor's device
    before they are concatenated or returned: the reassembled frame is
    host-facing, and the executor's readiness event lives there.  Under
    the sequential fallback every block already is there: no copy."""
    if devices is None:
        return blocks
    return [b.to(ctx.device) for b in blocks]


def _fold_kernel(kernel, ext: int) -> torch.Tensor:
    """Re-express ``kernel``'s circular row support on an ``ext``-row tile.

    Each support offset lands at ``offset % ext``; offsets are distinct mod
    ``ext`` because the tile always spans ``halo_top + halo_bottom + rows``
    with ``rows >= 1``.  Built on the host, returned on the kernel's
    device."""
    k, rows = _host_rows(kernel)
    h = k.shape[-2]
    out = np.zeros((ext,) + k.shape[-1:], k.dtype)
    for r in rows:
        off = int(r) if r <= h // 2 else int(r) - h
        out[off % ext] = k[r]
    return torch.as_tensor(out, device=kernel.device)


def _bounded_put(cache: dict, key, value):
    if len(cache) >= _CACHE_MAX:
        cache.clear()
    cache[key] = value
    return value


class ShardedOpticalBackend(ExecutionBackend):
    """Scatter each batched invocation across ``ctx.n_devices`` accelerators.

    Wraps a registered inner backend; with ``ctx.n_devices == 1`` it is a
    transparent pass-through.  ``ctx.shard_mode`` selects the split:

      ``"auto"``   group-shard whenever whole frames can feed the fleet —
                   including shallow groups, which simply occupy fewer
                   devices (tight numerics, zero halo traffic); frame-shard
                   only when a frame is genuinely too big for one aperture
                   (``usable_pixels``) or MVM core.  ``fft`` always
                   group-shards.
      ``"group"``  always scatter the batch.
      ``"frame"``  always tile frames (conv: overlap-save halos; matmul:
                   row split; fft falls back to group).
    """

    def __init__(self, inner: str = "optical-sim") -> None:
        self.inner_name = inner
        self.name = "sharded" if inner == "optical-sim" else f"sharded-{inner}"
        self._inner: ExecutionBackend | None = None
        self._last_device_samples: list[tuple[int, int]] | None = None
        # kernel content key (+ tile height, + device) -> host-derived data
        self._halo_cache: dict[tuple, tuple[int, int]] = {}
        self._fold_cache: dict[tuple, torch.Tensor] = {}
        # (operand content key, device) -> the operand on that card
        self._local_cache: dict[tuple, torch.Tensor] = {}
        # (category, frame shape, dtype) -> committed device placement
        self._placements: dict[tuple, _Placement] = {}

    def _halo(self, kernel: torch.Tensor,
              ctx: BackendContext) -> tuple[int, int]:
        """Cached :func:`kernel_halo`, keyed by the kernel's content key
        (memoized by the context), so a repeat flush reads nothing back
        from the card."""
        key = ctx.content_key(kernel)
        hit = self._halo_cache.get(key)
        if hit is None:
            hit = _bounded_put(self._halo_cache, key, kernel_halo(kernel))
        return hit

    def _folded(self, kernel: torch.Tensor, ext: int,
                device: torch.device, ctx: BackendContext) -> torch.Tensor:
        """Cached :func:`_fold_kernel` on ``device``: one refold per
        (kernel content, tile height, card) instead of one per device per
        flush."""
        key = ctx.content_key(kernel) + (ext, str(device))
        hit = self._fold_cache.get(key)
        if hit is None:
            hit = _bounded_put(self._fold_cache, key,
                               _fold_kernel(kernel, ext).to(device))
        return hit

    def _local(self, t: torch.Tensor | None, device: torch.device,
               ctx: BackendContext) -> torch.Tensor | None:
        """``t`` (a kernel or weights operand) on ``device``: the operand
        itself when it is there already, else a copy made once per
        (content, card).  The reference leaves these uncommitted and lets
        jit move them; here a shard's operands must share its card."""
        if t is None or t.device == device:
            return t
        key = ctx.content_key(t) + (str(device),)
        hit = self._local_cache.get(key)
        if hit is None:
            hit = _bounded_put(self._local_cache, key, t.to(device))
        return hit

    @property
    def inner(self) -> ExecutionBackend:
        if self._inner is None:
            self._inner = get_backend(self.inner_name)
        return self._inner

    def supports(self, category: str, ctx: BackendContext) -> bool:
        return self.inner.supports(category, ctx)

    def take_device_samples(self) -> list[tuple[int, int]] | None:
        """Per-device (samples_in, samples_out) of the last ``run`` — popped
        by the executor right after dispatch and recorded into telemetry at
        retire time."""
        samples, self._last_device_samples = self._last_device_samples, None
        return samples

    # -- device-resident placements --------------------------------------------
    def _survivor_pool(self, ctx) -> list[int]:
        """Logical device slots currently healthy: the fleet minus
        quarantined devices (device 0 serves alone when all are out)."""
        q = ctx.quarantine
        now = ctx.clock()
        n = max(1, int(ctx.n_devices))
        pool = [d for d in range(n)
                if q is None or not q.is_quarantined(("device", d), now)]
        return pool or [0]

    def commit_placement(self, category, xs, ctx, *, kernel=None,
                         weights=None, tile_sizes=None):
        """Commit ONE sharded placement for a released group (the executor
        calls this before its tile loop whenever a residency cache is
        attached).

        The placement records which pool slot each frame belongs to,
        replicating the dispatch structure exactly: the group streams as
        ``tile_sizes`` sub-invocations and each tile shard-splits over the
        survivor pool, so slot assignment runs per tile.  Frames are NOT
        staged here — the first placed dispatch copies each frame to its
        card once (a residency miss) and every later tile/flush serves it
        from there (a hit, no DAC re-crossing).  Re-committing an
        unchanged group is free; a changed group re-maps and only the
        changed frames re-ship.  Returns the placement, or ``None`` when
        placements do not apply (no cache, single device, frame-sharded
        mode, or the sequential fallback)."""
        res = ctx.residency
        if res is None or not xs:
            return None
        if self._resolve_mode(category, xs, ctx) != "group":
            return None
        pool = self._survivor_pool(ctx)
        sizes = shard_sizes(len(xs), len(pool))
        pool = pool[:len(sizes)]
        # the physical device list is indexed by LOGICAL pool id, not by
        # slot position: a quarantine-shrunk pool like [0, 2, 3] must keep
        # staging logical device 2's frames on the SAME card its
        # ("device", 2) resident entries already live on, or a shard would
        # stack resident frames with fresh copies homed elsewhere
        devices = shard_devices(max(pool) + 1, ctx.device)
        if devices is None:
            # fewer real devices than the pool spans: dispatch is the
            # sequential fallback and nothing is committed device-side
            return None
        pkey = (category, tuple(xs[0].shape), str(xs[0].dtype))
        assign: dict[tuple, int] = {}
        start = 0
        for t in (tile_sizes if tile_sizes is not None else [len(xs)]):
            tile = xs[start:start + t]
            start += t
            s0 = 0
            for slot, size in enumerate(shard_sizes(len(tile), len(pool))):
                for x in tile[s0:s0 + size]:
                    assign[ctx.content_key(x)] = slot
                s0 += size
        cur = self._placements.get(pkey)
        if cur is not None and cur.pool == pool and cur.assign == assign:
            return cur
        if cur is not None:
            # drop the stale device buffers of frames that changed since
            # the last commit: their re-stage is about to copy a fresh one,
            # and keeping the old one resident would hold two copies of
            # the frame against the staging budget until LRU pressure
            # happened to evict the dead one
            op = operating_point(ctx.spec)
            for ck, slot in cur.assign.items():
                if ck not in assign and slot < len(cur.pool):
                    res.discard(("device", cur.pool[slot]),
                                ("frame-shard", op, (ck,)), ctx=ctx)
        pl = _Placement(pool=pool, devices=devices, assign=assign,
                        frames=len(xs))
        self._placements[pkey] = pl
        tr = ctx.tracer
        if tr is not None:
            tr.instant("placement", lane="sched", event="commit",
                       category=category, frames=len(xs),
                       devices=len(pool),
                       rebuilt=cur is not None)
            tr.metrics.counter("placements", event="commit",
                               category=category).inc()
        return pl

    def _placement_for(self, category, xs, ctx) -> _Placement | None:
        """The committed placement covering every frame of ``xs``, if one
        exists and references only healthy devices; ``None`` routes the
        dispatch down the re-scatter path."""
        res = ctx.residency
        if res is None or not xs:
            return None
        pl = self._placements.get(
            (category, tuple(xs[0].shape), str(xs[0].dtype)))
        if pl is None:
            return None
        if any(ctx.content_key(x) not in pl.assign for x in xs):
            return None
        q = ctx.quarantine
        if q is not None:
            now = ctx.clock()
            if any(q.is_quarantined(("device", d), now) for d in pl.pool):
                return None
        return pl

    def _drop_placements_for_device(self, ctx, d: int) -> None:
        """Quarantine/device-loss cleanup: every placement referencing the
        dead device drops, so the next commit rebuilds on survivors."""
        stale = [k for k, pl in self._placements.items() if d in pl.pool]
        tr = ctx.tracer
        for k in stale:
            del self._placements[k]
            if tr is not None:
                tr.instant("placement", lane="sched", event="invalidate",
                           category=k[0], device=d)
                tr.metrics.counter("placements", event="invalidate",
                                   category=k[0]).inc()

    def _inner_run_on(self, category, shard, ctx, kernel, weights, device):
        """Run the inner backend on ``shard``'s card with the context's
        ``stage_stream`` pinned to logical ``device`` for the duration of
        the call, so delta classification's per-slot code signatures never
        alias across devices — two devices' same-shaped sub-groups stage
        into different physical write streams even under the sequential
        fallback.  The kernel/weights follow the shard to its card."""
        dev = shard[0].device
        kernel = self._local(kernel, dev, ctx)
        weights = self._local(weights, dev, ctx)
        prev = ctx.stage_stream
        ctx.stage_stream = ("device", device)
        try:
            return self.inner.run(category, shard, ctx, kernel=kernel,
                                  weights=weights)
        finally:
            ctx.stage_stream = prev

    # -- dispatch --------------------------------------------------------------
    def run(self, category, xs, ctx, *, kernel=None, weights=None):
        mode = self._resolve_mode(category, xs, ctx)
        if mode == "none":
            outs, cost = self.inner.run(category, xs, ctx, kernel=kernel,
                                        weights=weights)
            self._last_device_samples = [
                (sum(x.numel() for x in xs), sum(o.numel() for o in outs))]
            return outs, cost
        if mode == "group":
            return self._run_group(category, xs, ctx, kernel, weights)
        if self.inner_name not in _FRAME_INNERS:
            raise ValueError(
                f"frame sharding supports inners {_FRAME_INNERS}, "
                f"not {self.inner_name!r}")
        if category == "conv":
            return self._frame_conv(xs, ctx, kernel)
        if category == "matmul":
            return self._frame_matmul(xs, ctx, weights)
        raise ValueError(f"frame sharding does not support {category!r}")

    def _resolve_mode(self, category, xs, ctx) -> str:
        n = max(1, int(ctx.n_devices))
        if n == 1:
            return "none"
        if category == "fft":
            # the 2-D DFT is global: tiling one frame would need a
            # cross-device transpose between the row and column stages
            return "group"
        if ctx.shard_mode == "auto":
            # Group sharding whenever whole frames can feed every device
            # (tight numerics, zero halo traffic).  Tiling is reserved for
            # frames genuinely too big for one aperture/core — a shallow
            # group of small frames group-shards over fewer devices rather
            # than trading exactness for fan-out mid-flush.
            if len(xs) >= n or not self._frame_worthwhile(category, xs, ctx):
                return "group"
            return "frame"
        return ctx.shard_mode

    @staticmethod
    def _frame_worthwhile(category, xs, ctx) -> bool:
        """True when one frame overflows a single device's aperture (4f) or
        optical core (MVM), so tiling it is the only way to stop a lone
        device paying multiple serial settles/handshakes."""
        spec = ctx.spec
        if category == "conv":
            cap = getattr(spec, "usable_pixels", 0)
        else:
            cap = spec.rows * spec.cols if hasattr(spec, "rows") else 0
        return cap > 0 and xs[0].numel() > cap

    # -- (a) group sharding: scatter the stacked flush group -------------------
    def _run_group(self, category, xs, ctx, kernel, weights):
        pl = self._placement_for(category, xs, ctx)
        if pl is not None:
            return self._run_group_placed(category, xs, ctx, kernel,
                                          weights, pl)
        clock = ctx.clock
        # scatter only across survivors: quarantined devices sit out until
        # their probation window clears (with the whole fleet quarantined,
        # device 0 serves alone rather than the dispatch failing)
        pool = self._survivor_pool(ctx)
        # chaos-injected device loss is a property of THIS dispatch only;
        # the injector clears ctx.lost_devices after the run
        lost = frozenset(ctx.lost_devices or ())
        sizes = shard_sizes(len(xs), len(pool))
        devices = shard_devices(len(sizes), ctx.device)
        outs: list[torch.Tensor] = []
        costs: list[StepCost | None] = []
        samples: list[tuple[int, int]] = []
        start = 0
        for i, size in enumerate(sizes):
            shard = xs[start:start + size]
            start += size
            d = pool[i]
            t0 = clock()
            try:
                if d in lost:
                    raise DeviceLostError(d)
                with _device_span(ctx, d, size):
                    o, c = self._shard_dispatch(category, shard, ctx, kernel,
                                                weights, devices, i, device=d)
            except FaultError as e:
                # the shard's device failed mid-scatter: quarantine it and
                # re-run the SAME shard on a surviving device — every frame
                # still retires, from survivors, in order
                self._note_device_fault(ctx, category, d, e)
                self._quarantine_device(ctx, d, reason=e.kind)
                sv = next((s for s in pool if s != d and s not in lost), d)
                with _device_span(ctx, sv, size):
                    o, c = self._shard_dispatch(category, shard, ctx, kernel,
                                                weights, devices, i, device=sv)
                d = sv
            else:
                self._observe_shard(ctx, category, d, clock() - t0, c)
            outs.extend(o)
            costs.append(c)
            samples.append((sum(x.numel() for x in shard),
                            sum(v.numel() for v in o)))
        self._last_device_samples = samples
        return (_gather_blocks(outs, devices, ctx),
                self._combine(costs, len(sizes), ctx))

    def _shard_dispatch(self, category, shard, ctx, kernel, weights,
                        devices, slot, *, device=0):
        """One shard through the inner backend on placement ``slot``.

        With a residency cache attached, the copied shard list is kept
        under the LOGICAL device label ``("device", d)``: a re-scatter of
        the same frames to the same device skips the copy entirely (the
        per-shard grain is what makes partial residency real — only the
        shards whose content changed re-ship).  Quarantining a device
        drops its resident set, so a recovered device always re-stages.
        """
        if devices is not None:
            res = ctx.residency
            key = None
            if res is not None:
                key = residency_key(ctx, shard, "shard")
                cached = res.lookup(("device", device), key,
                                    category=category, ctx=ctx)
                if cached is not None:
                    return self._inner_run_on(category, cached, ctx,
                                              kernel, weights, device)
            with _stage_span(ctx, device, len(shard)):
                shard = [x.to(devices[slot % len(devices)]) for x in shard]
                if res is not None:
                    nbytes = sum(x.numel() * x.element_size()
                                 for x in shard)
                    res.store(("device", device), key, list(shard), nbytes,
                              category=category, kind="shard", ctx=ctx)
        return self._inner_run_on(category, shard, ctx, kernel, weights,
                                  device)

    def _run_group_placed(self, category, xs, ctx, kernel, weights, pl):
        """Group sharding through a committed device placement.

        Frames regroup by their committed slot (for a tile sub-stack this
        reproduces the tile's own ``shard_sizes`` split, so the stack
        shapes match the re-scatter path) and each shard serves its frames
        from per-device residency: only frames whose content changed since
        commit re-cross the host->device boundary, and the per-device
        output blocks gather only at readout.  A device fault mid-dispatch
        quarantines the device, drops the placement, and re-runs the shard
        on a survivor — the next commit rebuilds."""
        clock = ctx.clock
        lost = frozenset(ctx.lost_devices or ())
        slots: dict[int, list[int]] = {}
        for i, x in enumerate(xs):
            slots.setdefault(pl.assign[ctx.content_key(x)], []).append(i)
        outs: list = [None] * len(xs)
        costs: list[StepCost | None] = []
        samples: list[tuple[int, int]] = []
        for slot in sorted(slots):
            idxs = slots[slot]
            shard = [xs[i] for i in idxs]
            d = pl.pool[slot]
            t0 = clock()
            try:
                if d in lost:
                    raise DeviceLostError(d)
                with _device_span(ctx, d, len(shard)):
                    o, c = self._placed_dispatch(category, shard, ctx,
                                                 kernel, weights, pl, slot)
            except FaultError as e:
                self._note_device_fault(ctx, category, d, e)
                # drops this placement too (see _quarantine_device), so
                # the next commit rebuilds on the survivors
                self._quarantine_device(ctx, d, reason=e.kind)
                sv = next((s for s in pl.pool if s != d and s not in lost),
                          d)
                with _device_span(ctx, sv, len(shard)):
                    # pl.devices is logical-id indexed, so the survivor's
                    # own id is the right physical slot for the re-copy
                    o, c = self._shard_dispatch(
                        category, shard, ctx, kernel, weights, pl.devices,
                        sv % len(pl.devices), device=sv)
                d = sv
            else:
                self._observe_shard(ctx, category, d, clock() - t0, c)
            for i, v in zip(idxs, o):
                outs[i] = v
            costs.append(c)
            samples.append((sum(x.numel() for x in shard),
                            sum(v.numel() for v in o)))
        self._last_device_samples = samples
        return (_gather_blocks(outs, pl.devices, ctx),
                self._combine(costs, len(slots), ctx))

    def _placed_dispatch(self, category, shard, ctx, kernel, weights, pl,
                         slot):
        """One placed shard through the inner backend: every frame is
        served from (or committed into) its device's resident set at
        per-frame grain, so a tile sub-range and a repeat flush both hit
        without re-shipping unchanged neighbors.  The residency store
        replaces a changed frame's buffer in place — what keeps only
        *changed* shards re-crossing the DAC."""
        res = ctx.residency
        d = pl.pool[slot]
        # index the physical device by LOGICAL pool id, not slot position:
        # after a quarantine shrinks the pool, logical device d's resident
        # frames already live on devices[d], and stacking them with fresh
        # copies on a different card would fail
        dev = pl.devices[d % len(pl.devices)]
        served = []
        with _stage_span(ctx, d, len(shard)):
            for x in shard:
                key = residency_key(ctx, [x], "frame-shard")
                cached = res.lookup(("device", d), key, category=category,
                                    ctx=ctx)
                if cached is not None:
                    served.append(cached[0])
                    continue
                y = x.to(dev)
                res.store(("device", d), key, [y],
                          y.numel() * y.element_size(),
                          category=category, kind="frame-shard", ctx=ctx)
                served.append(y)
        return self._inner_run_on(category, served, ctx, kernel, weights, d)

    def _observe_shard(self, ctx, category, d, dt_s, cost):
        """Feed one healthy shard wall to the per-device straggler
        watchdog; ``patience`` consecutive stragglers quarantine the
        device (re-scattering subsequent groups across the survivors).

        ``dt_s`` is the executor clock around the shard's dispatch, and a
        CUDA launch returns before its work is done: on the card the
        watchdog sees the shard's host staging and launch time, not its
        device time — the reference's semantics under JAX's async
        dispatch.  No synchronize is added per shard, since that would
        change both the deadlines and the flush wall."""
        wd = ctx.watchdog
        q = ctx.quarantine
        if wd is None:
            return
        base = cost.total_s if cost is not None else None
        if not wd.observe(("device", self.name, d), dt_s, base):
            if q is not None:
                q.note_healthy(("device", d))
            return
        tel = ctx.telemetry
        if tel is not None:
            tel.note_fault(category, "straggle")
        tr = ctx.tracer
        if tr is not None:
            tr.instant("fault", lane=f"device{d}", category=category,
                       device=d, kind="straggle", elapsed_s=dt_s)
            tr.metrics.counter("faults", category=category,
                               kind="straggle").inc()
        if q is not None:
            ev = q.note_straggle(("device", d), ctx.clock())
            if ev is not None and tr is not None:
                q0 = tr.now()
                tr.record("quarantine", q0, q0 + (ev.until - ev.t),
                          lane=f"device{d}", kind="async", key=str(ev.key),
                          reason=ev.reason, level=ev.level)
                tr.metrics.counter("quarantines", reason=ev.reason).inc()

    def _note_device_fault(self, ctx, category, d, exc):
        tel = ctx.telemetry
        if tel is not None:
            tel.note_fault(category, exc.kind)
        tr = ctx.tracer
        if tr is not None:
            tr.instant("fault", lane=f"device{d}", category=category,
                       device=d, kind=exc.kind)
            tr.metrics.counter("faults", category=category,
                               kind=exc.kind).inc()

    def _quarantine_device(self, ctx, d, *, reason):
        # a quarantined device's memory is no longer trustworthy (and the
        # scheduler will route around it anyway): drop its resident set so
        # nothing serves stale bytes when it rejoins the pool, and every
        # placement that mapped frames onto it
        res = ctx.residency
        if res is not None:
            res.invalidate_device(("device", d), ctx=ctx)
        self._drop_placements_for_device(ctx, d)
        q = ctx.quarantine
        if q is None:
            return None
        ev = q.quarantine(("device", d), ctx.clock(), reason=reason)
        tr = ctx.tracer
        if tr is not None:
            q0 = tr.now()
            tr.record("quarantine", q0, q0 + (ev.until - ev.t),
                      lane=f"device{d}", kind="async", key=str(ev.key),
                      reason=ev.reason, level=ev.level)
            tr.metrics.counter("quarantines", reason=ev.reason).inc()
        return ev

    # -- (b) frame sharding: tile frames onto multiple apertures ---------------
    def _frame_conv(self, xs, ctx, kernel):
        h, w = int(xs[0].shape[-2]), int(xs[0].shape[-1])
        sizes = shard_sizes(h, ctx.n_devices)
        if len(sizes) == 1:
            return self.run("conv", xs, dataclasses.replace(ctx, n_devices=1),
                            kernel=kernel)
        halo_t, halo_b = self._halo(kernel, ctx)
        stack = torch.stack(list(xs))
        optical = self.inner_name == "optical-sim"
        if optical:
            # one affine range map for the WHOLE frame (the host knows the
            # full frame before scattering tiles), so the DAC quantization
            # grid is identical to the unsharded invocation; only the
            # per-tile detector auto-exposure differs across devices
            lo, scale = conv_range_map(stack)
            v = (stack - lo) / scale
        else:
            v = stack
        devices = shard_devices(len(sizes), ctx.device)
        res = ctx.residency if devices is not None else None
        blocks, costs, samples = [], [], []
        r0 = 0
        for d, rows in enumerate(sizes):
            with _device_span(ctx, d, len(xs)):
                ext = rows + halo_t + halo_b
                # per-device tile residency: the halo slice is a pure
                # function of the frames' content and the slice geometry
                # (the range map is frame-derived too), so an unchanged
                # tile of an unchanged stack serves device-resident on
                # repeat flushes instead of re-slicing + re-shipping
                tkey = None
                sub = None
                if res is not None:
                    tkey = residency_key(
                        ctx, list(xs),
                        f"ctile-{d}-{r0}-{rows}-{halo_t}-{halo_b}")
                    cached = res.lookup(("device", d), tkey,
                                        category="conv", ctx=ctx)
                    if cached is not None:
                        sub = cached[0]
                if sub is None:
                    idx = torch.arange(r0 - halo_t, r0 + rows + halo_b,
                                       device=v.device) % h
                    sub = v.index_select(1, idx)
                    if devices is not None:
                        sub = sub.to(devices[d])
                    if tkey is not None:
                        res.store(("device", d), tkey, [sub],
                                  sub.numel() * sub.element_size(),
                                  category="conv", kind="frame-tile",
                                  ctx=ctx)
                k_sub = self._folded(kernel, ext, sub.device, ctx)
                if optical:
                    out_sub = optical_conv2d_batched(sub, ctx.mask(k_sub),
                                                     ctx.sim_params, None)
                else:
                    out_sub = _host_circular_conv(sub, k_sub)
            blocks.append(out_sub[:, halo_t:halo_t + rows, :])
            samples.append((sub.numel(), len(xs) * rows * w))
            costs.append(self._frame_conv_cost(ctx, ext * w, rows * w,
                                               len(xs)))
            r0 += rows
        with _gather_span(ctx, len(blocks)):
            out = torch.cat(_gather_blocks(blocks, devices, ctx), dim=1)
        if optical:
            out = out * scale + lo * torch.sum(kernel)
        self._last_device_samples = samples
        return list(out), self._combine(costs, len(sizes), ctx)

    def _frame_matmul(self, xs, ctx, weights):
        m = int(xs[0].shape[0])
        kdim = int(xs[0].shape[1])
        nout = int(weights.shape[-1])
        sizes = shard_sizes(m, ctx.n_devices)
        if len(sizes) == 1:
            return self.run("matmul", xs,
                            dataclasses.replace(ctx, n_devices=1),
                            weights=weights)
        stack = torch.stack(list(xs))
        devices = shard_devices(len(sizes), ctx.device)
        res = ctx.residency if devices is not None else None
        blocks, costs, samples = [], [], []
        r0 = 0
        for d, rows in enumerate(sizes):
            with _device_span(ctx, d, len(xs)):
                # per-device tile residency, as in _frame_conv: an
                # unchanged row block of an unchanged activation stack
                # stays device-resident across flushes
                tkey = None
                sub = None
                if res is not None:
                    tkey = residency_key(ctx, list(xs),
                                         f"mtile-{d}-{r0}-{rows}")
                    cached = res.lookup(("device", d), tkey,
                                        category="matmul", ctx=ctx)
                    if cached is not None:
                        sub = cached[0]
                if sub is None:
                    sub = stack[:, r0:r0 + rows, :]
                    if devices is not None:
                        sub = sub.to(devices[d])
                    if tkey is not None:
                        res.store(("device", d), tkey, [sub],
                                  sub.numel() * sub.element_size(),
                                  category="matmul", kind="frame-tile",
                                  ctx=ctx)
                w_sub = self._local(weights, sub.device, ctx)
                if self.inner_name == "optical-sim":
                    out_sub = _optical_matmul_batched(
                        sub, w_sub, dac_bits=ctx.spec.dac.bits,
                        adc_bits=ctx.spec.adc.bits)
                else:
                    out_sub = _host_matmul(sub, w_sub)
            blocks.append(out_sub)
            samples.append((sub.numel(), out_sub.numel()))
            costs.append(self._frame_matmul_cost(ctx, len(xs), rows, kdim,
                                                 nout))
            r0 += rows
        with _gather_span(ctx, len(blocks)):
            out = torch.cat(_gather_blocks(blocks, devices, ctx), dim=1)
        self._last_device_samples = samples
        return list(out), self._combine(costs, len(sizes), ctx)

    # -- pricing ---------------------------------------------------------------
    def _combine(self, costs, n_eff: int, ctx) -> StepCost | None:
        """Max-over-devices: the invocation retires when the slowest
        (largest) shard's boundary crossing does; the sync barrier scales
        with the participant count.  Host-like inners price by measured
        wall (None propagates); the ideal bound stays sync-free — a
        zero-boundary accelerator has nothing to synchronize through."""
        if any(c is None for c in costs):
            return None
        worst = max(costs, key=lambda c: c.total_s)
        sync = getattr(ctx.spec, "device_sync_s", 0.0)
        if self.inner_name == "ideal" or sync <= 0.0:
            return worst
        return dataclasses.replace(
            worst, interface_s=worst.interface_s + n_eff * sync)

    def _frame_conv_cost(self, ctx, n_in: int, n_out: int,
                         batch: int) -> StepCost | None:
        if self.inner_name == "host":
            return None
        spec = ctx.spec
        if self.inner_name == "ideal":
            return ideal_step_cost(spec, "conv", batch)
        spec4 = dataclasses.replace(spec, phase_shift_captures=CONV_CAPTURES)
        return spec4.batched_step_cost(n_in, n_out, batch=batch,
                                       pipeline_depth=ctx.pipeline_depth)

    def _frame_matmul_cost(self, ctx, batch: int, rows: int, kdim: int,
                           nout: int) -> StepCost | None:
        if self.inner_name == "host":
            return None
        spec = ctx.spec
        if self.inner_name == "ideal":
            return ideal_step_cost(spec, "matmul", batch)
        return dataclasses.replace(
            spec.matmul_cost(batch * rows, kdim, nout),
            interface_s=spec.interface_latency_s)


register_backend("sharded", ShardedOpticalBackend)
register_backend("sharded-host", lambda: ShardedOpticalBackend(inner="host"))
register_backend("sharded-ideal", lambda: ShardedOpticalBackend(inner="ideal"))
