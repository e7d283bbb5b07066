"""Execution telemetry: measured per-category traffic -> ``CategoryProfile``s.

The planner (``repro_torch.core.planner``) prices offload from a workload profile.
The seed repo fed it *hand-written* profiles (or ``OpProfiler`` brackets the
caller had to place manually).  The runtime records the same quantities as a
side effect of executing requests — call counts, boundary sample counts,
wall time — keyed by ``(category, backend)``, so after any traffic has
flowed through the :class:`~repro_torch.runtime.executor.OffloadExecutor` the
observed workload can be handed straight back to ``plan_offload``:

    telemetry.start()
    ... route traffic through the executor ...
    telemetry.stop()
    plan = plan_offload(telemetry.profiles(), spec)

closing the paper's profile -> plan -> execute -> re-profile loop.

``host_s`` in an emitted profile prefers wall time measured on the digital
backends (``host`` / ``ideal``) because that is the quantity the planner
compares accelerator pricing against; a category observed only through the
optical-sim backend falls back to its simulated wall time (flagged via
:meth:`RuntimeTelemetry.host_timed`).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Sequence

from repro_torch.core.accelerator import StepCost
from repro_torch.core.planner import CategoryProfile
from repro_torch.runtime.metrics import Histogram

__all__ = ["BackendStats", "DeltaStats", "DeviceStats", "RuntimeTelemetry",
           "WindowStats"]

# Backends whose measured wall time is honest *host* time for planning
# (sharded-over-host still executes digitally, scattered or not).
_HOST_LIKE = ("host", "ideal", "sharded-host", "sharded-ideal")


@dataclasses.dataclass
class BackendStats:
    """Accumulated traffic for one (category, backend) pair."""

    calls: int = 0            # logical offload requests
    invocations: int = 0      # accelerator dispatches (batches) serving them
    samples_in: int = 0       # scalars that crossed (or would cross) the DAC
    samples_out: int = 0      # scalars back through the ADC
    wall_s: float = 0.0       # measured execution wall time
    bytes_in: int = 0         # measured operand bytes staged per dispatch
    bytes_out: int = 0        # measured result bytes read back
    modeled: StepCost = StepCost(0.0, 0.0, 0.0, 0.0)
    # per-tile samples: invocation depth (calls coalesced into ONE
    # dispatched stack — the tile size under memory-budgeted tiling) ->
    # how many invocations dispatched at that depth
    tiles: dict = dataclasses.field(default_factory=dict)

    def add(self, *, calls: int, samples_in: int, samples_out: int,
            wall_s: float, modeled: StepCost | None,
            bytes_in: int = 0, bytes_out: int = 0) -> None:
        self.calls += calls
        self.invocations += 1
        self.samples_in += samples_in
        self.samples_out += samples_out
        self.wall_s += wall_s
        self.bytes_in += bytes_in
        self.bytes_out += bytes_out
        self.tiles[calls] = self.tiles.get(calls, 0) + 1
        if modeled is not None:
            self.modeled = self.modeled + modeled


@dataclasses.dataclass
class DeviceStats:
    """Boundary traffic one simulated device absorbed under sharded offload."""

    invocations: int = 0      # sharded invocations this device took part in
    samples_in: int = 0       # scalars through THIS device's DAC
    samples_out: int = 0      # scalars back through THIS device's ADC


@dataclasses.dataclass
class DeltaStats:
    """Delta-staging ledger for one category: how many written operands
    took the partial (delta-encoded) write versus the full re-stage, and
    the summed flip fraction of the delta writes — the mean flip fraction
    is what the router feeds back into write-side deadline pricing."""

    frames: int = 0           # operands staged as delta writes
    full: int = 0             # written operands that re-staged in full
    flip_sum: float = 0.0     # sum of delta writes' flip fractions

    @property
    def mean_flip_fraction(self) -> float:
        return self.flip_sum / self.frames if self.frames else 0.0


@dataclasses.dataclass
class WindowStats:
    """Per-engine pipeline-window occupancy for one (category, backend).

    Recorded at every dispatch: how many of this engine's invocations were
    in flight the moment the new one entered its window (including
    itself), against the window depth it gated on.  The mean occupancy is
    the overlap the engine *actually achieved* — the measured counterpart
    of the cost model's ``engines=`` composition claim."""

    dispatches: int = 0       # invocations gated through this window
    in_flight_sum: int = 0    # sum of occupancy-at-dispatch (incl. self)
    peak: int = 0             # deepest occupancy observed
    depth: int = 0            # window depth at the last dispatch

    def add(self, *, in_flight: int, depth: int) -> None:
        self.dispatches += 1
        self.in_flight_sum += in_flight
        self.peak = max(self.peak, in_flight)
        self.depth = depth

    @property
    def mean_occupancy(self) -> float:
        return (self.in_flight_sum / self.dispatches
                if self.dispatches else 0.0)


# How many recent submit timestamps back the arrival-rate estimate (enough
# to smooth Poisson burstiness, few enough to track a changing rate).
_ARRIVAL_WINDOW = 64


class RuntimeTelemetry:
    """Records executor traffic and emits measured ``CategoryProfile``s."""

    def __init__(self) -> None:
        self.stats: dict[tuple[str, str], BackendStats] = \
            collections.defaultdict(BackendStats)
        # (category, backend) -> device index -> per-device boundary traffic
        self.device_stats: dict[tuple[str, str], dict[int, DeviceStats]] = \
            collections.defaultdict(dict)
        # category -> recent submit timestamps (the arrival process itself,
        # recorded at submit rather than dispatch so held traffic still has
        # an honest rate estimate)
        self._submits: dict[str, collections.deque[float]] = \
            collections.defaultdict(
                lambda: collections.deque(maxlen=_ARRIVAL_WINDOW))
        # (category, backend) -> per-invocation wall-time histogram: the
        # percentile view (p50/p95/p99) the multi-tenant SLO roadmap item
        # needs — totals say how much, percentiles say how consistently
        self._latency: dict[tuple[str, str], Histogram] = {}
        # category -> fault-kind counter ("error" / "straggle" / "drift" /
        # "device_loss" / "fallback" / "reroute"): the goodput-under-faults
        # ledger the chaos bench and operators read
        self.fault_counts: dict[str, collections.Counter] = \
            collections.defaultdict(collections.Counter)
        # category -> recovery-latency histogram: first fault of a dispatch
        # to its successful (possibly degraded) completion
        self._recovery: dict[str, Histogram] = {}
        # category -> residency-event counter ("hit" / "miss" / "eviction"
        # / "invalidation"): the operand-residency ledger — per-category
        # hit rate is what the router weighs batch depth against
        self.residency_counts: dict[str, collections.Counter] = \
            collections.defaultdict(collections.Counter)
        # category -> delta-staging ledger: delta-written vs fully
        # re-staged operand counts and summed flip fractions — the
        # write-side signal `replan` weighs alongside the hit rate
        self.delta_stats: dict[str, DeltaStats] = \
            collections.defaultdict(DeltaStats)
        # (category, backend) -> pipeline-window occupancy: the per-engine
        # in-flight depth each dispatch actually found — the measured
        # overlap the `engines=` composed price is judged against
        self.engine_windows: dict[tuple[str, str], WindowStats] = \
            collections.defaultdict(WindowStats)
        self._t0: float | None = None
        self._window_s: float = 0.0
        self._in_window_s: float = 0.0  # recorded wall inside the window

    # -- whole-run window (for the non-offloadable 'other' bucket) -----------
    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        """Close the measurement window; idempotent.  ``stop`` without a
        matching ``start`` (teardown paths can hit this — an example's
        ``finally`` block, a reset mid-window) is a no-op returning the
        accumulated window, not an error."""
        if self._t0 is not None:
            self._window_s += time.perf_counter() - self._t0
            self._t0 = None
        return self._window_s

    @property
    def window_s(self) -> float:
        return self._window_s

    # -- arrival process (the scheduler's admission signal) -------------------
    def note_submit(self, category: str, t: float | None = None) -> None:
        """Record one offload submission at time ``t`` (the executor stamps
        its own clock so submit ages and arrival rates share a timebase)."""
        self._submits[category].append(
            time.perf_counter() if t is None else t)

    def arrival_rate(self, category: str) -> float:
        """Estimated submit arrival rate for ``category`` in calls/second,
        from the recent submit timestamps (0.0 until two arrivals have been
        seen — no estimate is *no* claim, not a claim of zero traffic; the
        scheduler treats it as "hold until the deadline says otherwise").

        A burst of simultaneous submits (span ~0) estimates ``inf``:
        the next arrival is expected immediately, so waiting is free."""
        ts = self._submits.get(category)
        if ts is None or len(ts) < 2:
            return 0.0
        span = ts[-1] - ts[0]
        if span <= 0.0:
            return float("inf")
        return (len(ts) - 1) / span

    # -- recording (called by the executor) ----------------------------------
    def record(self, category: str, backend: str, *, calls: int,
               samples_in: int, samples_out: int, wall_s: float,
               modeled: StepCost | None = None,
               per_device: Sequence[tuple[int, int]] | None = None,
               bytes_in: int = 0, bytes_out: int = 0) -> None:
        self.stats[(category, backend)].add(
            calls=calls, samples_in=samples_in, samples_out=samples_out,
            wall_s=wall_s, modeled=modeled, bytes_in=bytes_in,
            bytes_out=bytes_out)
        self._latency.setdefault((category, backend),
                                 Histogram()).record(wall_s)
        if per_device:
            devs = self.device_stats[(category, backend)]
            for i, (s_in, s_out) in enumerate(per_device):
                st = devs.setdefault(i, DeviceStats())
                st.invocations += 1
                st.samples_in += int(s_in)
                st.samples_out += int(s_out)
        if self._t0 is not None:  # only in-window traffic offsets 'other'
            self._in_window_s += wall_s

    def note_fault(self, category: str, kind: str) -> None:
        """Count one fault event against ``category`` (the executor's
        retry path, the sharded backend's per-device recovery, and the
        drift-correction path all report through here)."""
        self.fault_counts[category][kind] += 1

    def note_recovery(self, category: str, dt_s: float) -> None:
        """Record one recovery latency: the span from a dispatch's first
        fault to the caller having a correct result again."""
        self._recovery.setdefault(category, Histogram()).record(max(dt_s,
                                                                    0.0))

    def note_window(self, category: str, backend: str, *,
                    in_flight: int, depth: int) -> None:
        """Record one dispatch's pipeline-window occupancy for the
        ``(category, backend)`` engine (the executor reports at every
        invocation, after gating on the engine's window)."""
        self.engine_windows[(category, backend)].add(in_flight=in_flight,
                                                     depth=depth)

    def window_occupancy(self, category: str | None = None,
                         backend: str | None = None) -> float:
        """Mean in-flight-at-dispatch occupancy across the matching engine
        windows (dispatch-weighted); 0.0 when nothing dispatched."""
        disp = occ = 0
        for (cat, be), st in self.engine_windows.items():
            if category is not None and cat != category:
                continue
            if backend is not None and be != backend:
                continue
            disp += st.dispatches
            occ += st.in_flight_sum
        return occ / disp if disp else 0.0

    def note_residency(self, category: str, event: str) -> None:
        """Count one residency-cache event ("hit" / "miss" / "eviction" /
        "invalidation") against ``category`` (mirrored here by the
        ``ResidencyCache`` whenever a context with telemetry is attached)."""
        self.residency_counts[category][event] += 1

    def residency_hit_rate(self, category: str | None = None,
                           ) -> float | None:
        """hits / (hits + misses) for ``category`` (overall when None);
        ``None`` before any residency lookup — no traffic is no claim,
        and the router treats it as rate 0."""
        hits = misses = 0
        for cat, c in self.residency_counts.items():
            if category is not None and cat != category:
                continue
            hits += c.get("hit", 0)
            misses += c.get("miss", 0)
        total = hits + misses
        return None if total == 0 else hits / total

    def note_delta(self, category: str, *,
                   flip_fraction: float | None = None) -> None:
        """Count one *written* (non-hit) operand staging against
        ``category``: with a ``flip_fraction`` it was a delta-encoded
        partial write at that measured LSB flip fraction; with ``None``
        it re-staged in full (first sighting, or a flip fraction past
        the delta threshold)."""
        st = self.delta_stats[category]
        if flip_fraction is None:
            st.full += 1
        else:
            st.frames += 1
            st.flip_sum += max(0.0, min(1.0, float(flip_fraction)))

    def delta_rate(self, category: str | None = None) -> float | None:
        """delta writes / all writes for ``category`` (overall when None);
        ``None`` before any write-side staging was classified — no traffic
        is no claim, and the router treats it as rate 0."""
        frames = full = 0
        for cat, st in self.delta_stats.items():
            if category is not None and cat != category:
                continue
            frames += st.frames
            full += st.full
        total = frames + full
        return None if total == 0 else frames / total

    def mean_flip_fraction(self, category: str | None = None) -> float:
        """Mean LSB flip fraction across the observed delta writes for
        ``category`` (overall when None); 0.0 when none occurred."""
        frames = 0
        flips = 0.0
        for cat, st in self.delta_stats.items():
            if category is not None and cat != category:
                continue
            frames += st.frames
            flips += st.flip_sum
        return flips / frames if frames else 0.0

    def faults_total(self, category: str | None = None) -> int:
        """Total fault events observed (for ``category``, or overall)."""
        if category is not None:
            return sum(self.fault_counts.get(category, {}).values())
        return sum(sum(c.values()) for c in self.fault_counts.values())

    def recovery_stats(self, category: str | None = None) -> dict | None:
        """``{n, mean_s, p50_s, p95_s}`` of recovery latency for
        ``category`` (merged across categories when None); ``None`` when
        nothing ever needed recovering."""
        merged: Histogram | None = None
        for cat, h in self._recovery.items():
            if category is not None and cat != category:
                continue
            if merged is None:
                merged = h.copy()
            else:
                merged.merge(h)
        if merged is None or merged.n == 0:
            return None
        return {"n": merged.n, "mean_s": merged.total / merged.n,
                "p50_s": merged.percentile(50),
                "p95_s": merged.percentile(95)}

    def discount_window(self, wall_s: float) -> None:
        """Exclude ``wall_s`` of measurement overhead (e.g. the fidelity
        checker's shadow reference run) from the window's 'other' bucket —
        it elapsed inside the window but is not workload."""
        if self._t0 is not None:
            self._in_window_s += wall_s

    # -- views ----------------------------------------------------------------
    def categories(self) -> tuple[str, ...]:
        seen: dict[str, None] = {}
        for cat, _ in self.stats:
            seen.setdefault(cat)
        return tuple(seen)

    def host_timed(self, category: str) -> bool:
        """True when ``category`` has wall time from a host-like backend."""
        return any(self.stats[(category, b)].wall_s > 0.0
                   for b in _HOST_LIKE if (category, b) in self.stats)

    def _category_rollup(self, category: str) -> tuple[int, int, int, float]:
        calls = s_in = s_out = host_calls = 0
        host_s = other_s = 0.0
        for (cat, backend), st in self.stats.items():
            if cat != category:
                continue
            calls += st.calls
            s_in += st.samples_in
            s_out += st.samples_out
            if backend in _HOST_LIKE:
                host_s += st.wall_s
                host_calls += st.calls
            else:
                other_s += st.wall_s
        if host_s > 0.0 and host_calls > 0:
            # price ALL observed calls at the measured host rate, so a
            # category that later ran offloaded is not under-weighted on
            # the host side of the next replan
            est = host_s * (calls / host_calls)
        else:
            est = other_s
        return calls, s_in, s_out, est

    def recorded_s(self) -> float:
        return sum(st.wall_s for st in self.stats.values())

    def samples_per_call(self, category: str) -> tuple[int, int]:
        """Observed mean boundary traffic per call: (n_in, n_out) scalars.

        This is what adaptive batching prices invocations from — the
        per-call DAC/ADC sample counts the category's traffic actually
        exhibited, not a hand-written workload guess."""
        calls = s_in = s_out = 0
        for (cat, _backend), st in self.stats.items():
            if cat != category:
                continue
            calls += st.calls
            s_in += st.samples_in
            s_out += st.samples_out
        if calls <= 0:
            return (0, 0)
        return (s_in // calls, s_out // calls)

    def device_samples(self, category: str) -> dict[int, tuple[int, int]]:
        """Per-device aggregated boundary traffic for ``category``:
        ``{device_index: (samples_in, samples_out)}`` summed across
        backends.  Empty when the category never ran sharded."""
        out: dict[int, list[int]] = {}
        for (cat, _backend), devs in self.device_stats.items():
            if cat != category:
                continue
            for i, st in devs.items():
                acc = out.setdefault(i, [0, 0])
                acc[0] += st.samples_in
                acc[1] += st.samples_out
        return {i: (s[0], s[1]) for i, s in sorted(out.items())}

    def devices_observed(self, category: str | None = None) -> int:
        """Widest device fan-out any recorded invocation used (1 when no
        sharded traffic was recorded)."""
        widest = 1
        for (cat, _backend), devs in self.device_stats.items():
            if category is not None and cat != category:
                continue
            widest = max(widest, len(devs))
        return widest

    def tile_sizes_observed(self, category: str) -> dict[int, int]:
        """Per-tile samples: ``{invocation depth: dispatch count}`` merged
        across backends — the tile granularity the executor *actually*
        dispatched at.  A monolithic K-deep flush shows ``{K: 1}``; the
        same group streamed through a ``tile_k=4`` budget shows
        ``{4: K//4, ...}`` (plus a ragged tail entry).  Benchmarks assert
        the budget-chosen ``tile_k`` against this — the tile the planner
        picked must be the tile the boundary saw."""
        out: dict[int, int] = {}
        for (cat, _backend), st in self.stats.items():
            if cat != category:
                continue
            for size, count in st.tiles.items():
                out[size] = out.get(size, 0) + count
        return dict(sorted(out.items()))

    def latency_histogram(self, category: str,
                          backend: str | None = None) -> Histogram | None:
        """Per-invocation wall-time histogram for ``(category, backend)``
        — or, with ``backend=None``, a merged copy across every backend
        that served the category.  ``None`` when no traffic recorded."""
        if backend is not None:
            h = self._latency.get((category, backend))
            return None if h is None else h.copy()
        merged: Histogram | None = None
        for (cat, _b), h in self._latency.items():
            if cat != category:
                continue
            if merged is None:
                merged = h.copy()
            else:
                merged.merge(h)
        return merged

    def percentiles(self, category: str, backend: str | None = None,
                    ps: Sequence[float] = (50.0, 95.0, 99.0),
                    ) -> dict[float, float]:
        """p50/p95/p99 (by default) of per-invocation wall time for
        ``(category, backend)`` — NaN-valued when no traffic recorded, so
        SLO dashboards can render the absence without special-casing."""
        h = self.latency_histogram(category, backend)
        if h is None:
            return {p: float("nan") for p in ps}
        return h.percentiles(ps)

    def bytes_per_frame(self, category: str) -> int:
        """Measured mean staged bytes per call (operand in + result out) —
        the ground truth the tiling model's working-set estimate is judged
        against.  0 until traffic with byte accounting has flowed."""
        calls = total = 0
        for (cat, _backend), st in self.stats.items():
            if cat != category:
                continue
            calls += st.calls
            total += st.bytes_in + st.bytes_out
        if calls <= 0:
            return 0
        return total // calls

    def observed_occupancy(self, category: str | None = None) -> int:
        """Average calls coalesced per invocation in the observed traffic,
        per category (or globally when ``category`` is None).

        This is the amortization the workload *actually achieved* — pricing
        a plan at a deeper batch than a category's traffic exhibits would
        credit the accelerator with handshake amortization it never gets,
        and one category's deep batches must not subsidize another's
        serial calls."""
        calls = invocations = 0
        for (cat, _backend), st in self.stats.items():
            if category is not None and cat != category:
                continue
            calls += st.calls
            invocations += st.invocations
        if invocations <= 0:
            return 1
        return max(1, round(calls / invocations))

    # -- the loop-closing output ----------------------------------------------
    def profiles(self, include_other: bool = True) -> list[CategoryProfile]:
        """Observed traffic as planner input.

        One profile per executed category, plus (when a start/stop window was
        used) an ``other`` profile holding the non-offloadable remainder of
        the window — exactly the shape ``plan_offload`` expects.
        """
        out: list[CategoryProfile] = []
        for cat in self.categories():
            calls, s_in, s_out, host_s = self._category_rollup(cat)
            out.append(CategoryProfile(cat, host_s=host_s, calls=max(calls, 1),
                                       samples_in=s_in, samples_out=s_out))
        if include_other and self._window_s > 0.0:
            other = max(self._window_s - self._in_window_s, 0.0)
            out.append(CategoryProfile("other", host_s=other))
        return out

    def merge(self, other: "RuntimeTelemetry") -> None:
        for key, st in other.stats.items():
            mine = self.stats[key]
            mine.calls += st.calls
            mine.invocations += st.invocations
            mine.samples_in += st.samples_in
            mine.samples_out += st.samples_out
            mine.wall_s += st.wall_s
            mine.bytes_in += st.bytes_in
            mine.bytes_out += st.bytes_out
            mine.modeled = mine.modeled + st.modeled
            for size, count in st.tiles.items():
                mine.tiles[size] = mine.tiles.get(size, 0) + count
        for key, devs in other.device_stats.items():
            mine_devs = self.device_stats[key]
            for i, st in devs.items():
                acc = mine_devs.setdefault(i, DeviceStats())
                acc.invocations += st.invocations
                acc.samples_in += st.samples_in
                acc.samples_out += st.samples_out
        for cat, ts in other._submits.items():
            mine_ts = self._submits[cat]
            merged = sorted(list(mine_ts) + list(ts))
            mine_ts.clear()
            mine_ts.extend(merged[-_ARRIVAL_WINDOW:])
        for key, h in other._latency.items():
            if key in self._latency:
                self._latency[key].merge(h)
            else:
                self._latency[key] = h.copy()
        for cat, counts in other.fault_counts.items():
            self.fault_counts[cat].update(counts)
        for cat, h in other._recovery.items():
            if cat in self._recovery:
                self._recovery[cat].merge(h)
            else:
                self._recovery[cat] = h.copy()
        for cat, counts in other.residency_counts.items():
            self.residency_counts[cat].update(counts)
        for cat, st in other.delta_stats.items():
            mine_d = self.delta_stats[cat]
            mine_d.frames += st.frames
            mine_d.full += st.full
            mine_d.flip_sum += st.flip_sum
        for key, st in other.engine_windows.items():
            mine_w = self.engine_windows[key]
            mine_w.dispatches += st.dispatches
            mine_w.in_flight_sum += st.in_flight_sum
            mine_w.peak = max(mine_w.peak, st.peak)
            mine_w.depth = st.depth or mine_w.depth
        self._window_s += other._window_s
        self._in_window_s += other._in_window_s

    def reset(self) -> None:
        self.stats.clear()
        self.device_stats.clear()
        self._submits.clear()
        self._latency.clear()
        self.fault_counts.clear()
        self._recovery.clear()
        self.residency_counts.clear()
        self.delta_stats.clear()
        self.engine_windows.clear()
        self._t0 = None
        self._window_s = 0.0
        self._in_window_s = 0.0

    def summary(self) -> str:
        rows = ["telemetry:"]
        for (cat, backend), st in sorted(self.stats.items()):
            rows.append(
                f"  {cat:>8}/{backend:<11} calls={st.calls} "
                f"batches={st.invocations} in={st.samples_in} "
                f"out={st.samples_out} wall={st.wall_s:.4g}s "
                f"modeled={st.modeled.total_s:.4g}s "
                f"(conv {st.modeled.conversion_s:.4g}s)")
            devs = self.device_stats.get((cat, backend))
            if devs:
                parts = [f"d{i}: in={d.samples_in} out={d.samples_out} "
                         f"x{d.invocations}" for i, d in sorted(devs.items())]
                rows.append(f"           devices[{len(devs)}] "
                            + "; ".join(parts))
            if len(st.tiles) > 1:  # tiled / mixed-depth dispatch is news
                parts = [f"depth{s} x{c}"
                         for s, c in sorted(st.tiles.items())]
                rows.append("           tiles: " + "; ".join(parts))
            h = self._latency.get((cat, backend))
            if h is not None and h.n > 1:  # percentiles of one are noise
                rows.append(
                    f"           wall p50={h.percentile(50):.3g}s "
                    f"p95={h.percentile(95):.3g}s "
                    f"p99={h.percentile(99):.3g}s (n={h.n})")
            w = self.engine_windows.get((cat, backend))
            if w is not None and w.dispatches:
                rows.append(
                    f"           window depth={w.depth} "
                    f"occupancy={w.mean_occupancy:.2f} peak={w.peak} "
                    f"(n={w.dispatches})")
        for cat, counts in sorted(self.fault_counts.items()):
            parts = [f"{k} x{c}" for k, c in sorted(counts.items())]
            row = f"  faults[{cat}]: " + "; ".join(parts)
            rec = self.recovery_stats(cat)
            if rec is not None:
                row += (f" | recovery p50={rec['p50_s']:.3g}s "
                        f"p95={rec['p95_s']:.3g}s (n={rec['n']})")
            rows.append(row)
        for cat, counts in sorted(self.residency_counts.items()):
            parts = [f"{k} x{c}" for k, c in sorted(counts.items())]
            row = f"  residency[{cat}]: " + "; ".join(parts)
            rate = self.residency_hit_rate(cat)
            if rate is not None:
                row += f" | hit rate {rate:.0%}"
            rows.append(row)
        for cat, st in sorted(self.delta_stats.items()):
            if st.frames or st.full:
                rows.append(
                    f"  delta[{cat}]: delta x{st.frames} full x{st.full}"
                    f" | mean flip {st.mean_flip_fraction:.1%}")
        if self._window_s:
            rows.append(f"  window={self._window_s:.4g}s "
                        f"recorded={self.recorded_s():.4g}s")
        return "\n".join(rows)
