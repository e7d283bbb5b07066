"""Plan-driven routing: consume an ``OffloadPlan``, don't just print it.

``PlanRouter`` is the piece that finally *uses* the planner's output: each
category the plan marked ``offload=True`` routes to the analog backend,
everything else stays on the host.  Because the executor records telemetry
as traffic flows, the router can then re-plan from *measured* profiles —
the closed loop the paper's methodology implies:

    router = PlanRouter(executor)          # starts all-host (profiling mode)
    ... serve traffic via router.run(...) ...
    plan = router.replan()                 # plan from observed workload
    ... keep serving; offload-worthy categories now hit the analog engine ...

``replan`` prices the observed profiles on the executor's spec with
``plan_offload`` and atomically swaps the routing table to match the new
plan's decisions.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.conversion import delta_write_scale
from repro_torch.core.planner import CategoryProfile, OffloadPlan, plan_offload
from repro_torch.runtime.backends import CATEGORIES, CONV_CAPTURES
from repro_torch.runtime.executor import OffloadExecutor, OffloadResult
from repro_torch.runtime.metrics import DriftReport, drift_report

__all__ = ["PlanRouter"]


class PlanRouter:
    """Routes op categories to backends according to an ``OffloadPlan``."""

    def __init__(self, executor: OffloadExecutor, plan: OffloadPlan | None = None,
                 *, offload_backend: str = "optical-sim",
                 host_backend: str = "host") -> None:
        self.executor = executor
        self.offload_backend = offload_backend
        self.host_backend = host_backend
        self.routes: dict[str, str] = {c: host_backend for c in CATEGORIES}
        self.plan: OffloadPlan | None = None
        # Operator-set per-category ceilings are constraints the adaptive
        # choice never exceeds — and never destroys: the original value is
        # snapshotted before the router writes a (possibly deadline-
        # lowered) ceiling of its own, so relaxing a deadline can raise
        # the ceiling back up to the operator's bound.  A ceiling is
        # recognized as operator-set when it differs from what this router
        # last wrote.  The same bookkeeping covers the sharded device
        # fan-out (``set_n_devices``).
        self._operator_caps: dict[str, int] = {}
        self._router_set: dict[str, int] = {}
        self._operator_dev_caps: dict[str, int] = {}
        self._router_set_dev: dict[str, int] = {}
        self._operator_tile_caps: dict[str, int] = {}
        self._router_set_tile: dict[str, int] = {}
        self._operator_window_caps: dict[str, int] = {}
        self._router_set_window: dict[str, int] = {}
        # modeled-vs-measured attribution from the executor's tracer,
        # refreshed by each replan (None when tracing is off / no spans)
        self.drift: DriftReport | None = None
        if plan is not None:
            self.apply(plan)

    @classmethod
    def from_plan(cls, executor: OffloadExecutor, plan: OffloadPlan,
                  **kwargs) -> "PlanRouter":
        return cls(executor, plan, **kwargs)

    # -- routing table ---------------------------------------------------------
    def apply(self, plan: OffloadPlan) -> None:
        """Swap the routing table to match ``plan``'s offload decisions."""
        routes = {c: self.host_backend for c in CATEGORIES}
        for d in plan.decisions:
            if d.category in routes and d.offload:
                routes[d.category] = self.offload_backend
        self.routes = routes
        self.plan = plan

    def backend_for(self, category: str) -> str:
        return self.routes.get(category, self.host_backend)

    def offloaded_categories(self) -> tuple[str, ...]:
        return tuple(c for c, b in self.routes.items()
                     if b != self.host_backend)

    # -- execution (delegates to the executor with the routed backend) ---------
    def submit(self, category: str, x, **kwargs) -> OffloadResult:
        kwargs.setdefault("backend", self.backend_for(category))
        return self.executor.submit(category, x, **kwargs)

    def run(self, category: str, x, **kwargs):
        return self.submit(category, x, **kwargs).get()

    def flush(self) -> list[OffloadResult]:
        return self.executor.flush()

    @property
    def pending(self) -> int:
        return self.executor.pending

    # -- adaptive batching + device fan-out + tile depth -----------------------
    def choose_sharding(self, deadline_s: float | None = None,
                        ) -> dict[str, tuple[int, int, int]]:
        """Pick per-category ``(max_batch, n_devices, tile_k)`` from
        measured telemetry.

        The amortization side of the trade wants the deepest batch the
        executor allows (every coalesced call shares the handshake, settle,
        and lane-ceil residue); the latency side caps it: with a
        ``deadline_s``, the modeled batched invocation — priced from the
        category's *observed* per-call boundary traffic at the executor's
        pipeline depth, its sharded device fan-out (max-over-devices plus
        sync), its memory-budgeted tile depth (each tile pays its own
        prologue, tiles overlap two-deep) AND its measured residency hit
        rate (frames the device already holds skip the write-side DAC
        crossing) — must still finish within the deadline, so the depth is
        halved until it fits.  Categories with no recorded traffic are
        left at the executor's global ceilings.

        The device count rides the batch (group sharding can never use
        more devices than the group has items: ``n = min(device cap, k)``)
        and the tile depth rides both: ``tile_k`` is what
        :func:`~repro_torch.runtime.tiling.choose_tile` picks for a ``k``-deep
        group of the category's observed frame size under the executor's
        budget — the SAME resolution dispatch uses, so the chosen tile is
        the dispatched tile.  The chosen ``max_batch`` and ``n_devices``
        are monotone non-increasing as the deadline tightens (the halving
        sequence is fixed, so a smaller deadline only ever stops it
        later); ``tile_k`` never exceeds the chosen batch or the budget's
        frame cap, but its even-split refinement may legitimately pick a
        *larger* divisor at a smaller batch (a 6-deep group tiles 3+3
        where a 16-deep one tiles 2x8 under the same cap).

        Per-category ceilings the *operator* set directly
        (``executor.set_max_batch`` / ``set_n_devices`` / ``set_tile_k``)
        are bounds the adaptive choice never exceeds; ceilings this router
        itself installed are re-derived from scratch on each call (so
        relaxing a deadline raises them again, up to the operator's bound
        where one exists).
        """
        from repro_torch.runtime.tiling import choose_tile

        ex, telemetry = self.executor, self.executor.telemetry
        spec = ex.spec
        chosen: dict[str, tuple[int, int, int]] = {}
        for cat in telemetry.categories():
            k = min(ex.max_batch, self._operator_bound(cat))
            n_cap = min(ex.n_devices, self._operator_device_bound(cat))
            q = getattr(ex, "quarantine", None)
            if q is not None:
                # quarantined devices are not capacity: the plan shrinks
                # its fan-out around them (at least one device always
                # remains — the sharded scatter falls back the same way)
                avail = ex.n_devices - q.active_device_count(ex.now())
                n_cap = max(1, min(n_cap, avail))
            tile_cap = self._operator_tile_bound(cat)
            n_in, n_out = telemetry.samples_per_call(cat)

            def tile_for(depth: int) -> int:
                if n_in <= 0:
                    return depth
                # resident operands occupy the same staging budget tiles
                # spend from, so the tile choice here must see the budget
                # the dispatcher will actually have left
                t = choose_tile(n_in, depth, ex.effective_mem_budget(),
                                n_out=n_out or None,
                                pipeline_depth=ex.pipeline_depth).tile_k
                if tile_cap is not None:
                    t = min(t, tile_cap)
                return max(1, min(t, depth))

            # the measured residency hit rate projects how many of a
            # k-deep group's frames the device already holds: a cache that
            # is absorbing most of the write traffic lets a deeper batch
            # fit the same deadline, so the halving loop prices it in
            hit_rate = telemetry.residency_hit_rate(cat) or 0.0
            # ...and the observed delta rate projects how many of the
            # remaining (written) frames take the delta-encoded partial
            # write at the observed mean flip fraction rather than a full
            # re-stage — the same write-side deadline relief, one notch
            # weaker than a hit
            d_rate = telemetry.delta_rate(cat) or 0.0
            mean_flip = telemetry.mean_flip_fraction(cat)
            dac_bits = getattr(getattr(spec, "dac", None), "bits", 1)

            def delta_proj(depth: int, resident: int) -> tuple:
                written = depth - resident
                n_delta = min(written, int(round(d_rate * written)))
                if n_delta <= 0:
                    return ()
                return (delta_write_scale(mean_flip, dac_bits),) * n_delta

            if (deadline_s is not None and n_in > 0
                    and hasattr(spec, "batched_step_cost")):
                pricing_spec = spec
                if cat == "conv" and hasattr(spec, "phase_shift_captures"):
                    # conv pays interferometric complex recovery: the
                    # backend prices it at 4 captures, so the deadline
                    # check must too or the chosen depth blows the bound
                    pricing_spec = dataclasses.replace(
                        spec, phase_shift_captures=CONV_CAPTURES)
                while k > 1:
                    resident = min(k, int(round(hit_rate * k)))
                    cost = pricing_spec.batched_step_cost(
                        n_in, n_out or None, batch=k,
                        pipeline_depth=ex.pipeline_depth,
                        n_devices=max(1, min(n_cap, k)),
                        tile_k=tile_for(k),
                        resident_frames=resident,
                        delta_fractions=delta_proj(k, resident))
                    if cost.total_s <= deadline_s:
                        break
                    k //= 2
            k = max(k, 1)
            chosen[cat] = (k, max(1, min(n_cap, k)), tile_for(k))
        return chosen

    def choose_windows(self) -> dict[str, int]:
        """Pick per-category pipeline *window* depths from measured
        telemetry.

        A category's window is how many of its invocations the executor
        lets ride in flight before retirement blocks the next submit
        (:meth:`~repro_torch.runtime.executor.OffloadExecutor.set_pipeline_window`).
        The useful depth is what the traffic actually achieved: a category
        whose invocations never overlapped (mean in-flight-at-dispatch
        occupancy ~1, from ``telemetry.window_occupancy``) collapses to a
        window of 1 and the cost model stops crediting it with pipelined
        hiding; a category that genuinely rode the window deep keeps the
        executor's full global depth.  The pick is
        ``min(operator bound, global pipeline_depth, round(measured
        occupancy))`` (floor 1) — monotone in the observed overlap, and
        never above the global depth so the back-compat alias stays the
        ceiling.

        Window depths the *operator* pinned directly
        (``executor.set_pipeline_window``) are bounds the adaptive choice
        never exceeds, with the same snapshot-before-overwrite bookkeeping
        as the batch/device/tile ceilings.
        """
        ex, telemetry = self.executor, self.executor.telemetry
        chosen: dict[str, int] = {}
        for cat in telemetry.categories():
            cap = self._operator_window_bound(cat)
            occ = max(1, round(telemetry.window_occupancy(cat)))
            chosen[cat] = max(1, min(cap, ex.pipeline_depth, occ))
        return chosen

    def choose_max_batch(self, deadline_s: float | None = None) -> dict[str, int]:
        """The batch slice of :meth:`choose_sharding` (kept for callers
        that predate sharded/tiled offload)."""
        return {cat: k for cat, (k, _n, _t)
                in self.choose_sharding(deadline_s).items()}

    def _operator_bound(self, cat: str) -> int:
        """Upper bound the operator imposed on ``cat``'s ceiling (the
        executor's global cap when they never set one).  A current ceiling
        that is not the router's own last write is (re-)snapshotted as the
        operator's."""
        current = self.executor.category_max_batches().get(cat)
        if current is not None and current != self._router_set.get(cat):
            self._operator_caps[cat] = current
        return self._operator_caps.get(cat, self.executor.max_batch)

    def _operator_device_bound(self, cat: str) -> int:
        """Like :meth:`_operator_bound`, for the sharded device fan-out."""
        current = self.executor.category_n_devices().get(cat)
        if current is not None and current != self._router_set_dev.get(cat):
            self._operator_dev_caps[cat] = current
        return self._operator_dev_caps.get(cat, self.executor.n_devices)

    def _operator_tile_bound(self, cat: str) -> int | None:
        """Like :meth:`_operator_bound`, for the tile depth — except the
        executor has no global tile ceiling (the budget is the default
        authority), so "no operator pin" is None, not a cap."""
        current = self.executor.category_tile_ks().get(cat)
        if current is not None and current != self._router_set_tile.get(cat):
            self._operator_tile_caps[cat] = current
        return self._operator_tile_caps.get(cat)

    def _operator_window_bound(self, cat: str) -> int:
        """Like :meth:`_operator_bound`, for the per-engine pipeline
        window depth (the executor's global ``pipeline_depth`` when the
        operator never pinned one)."""
        current = self.executor.category_windows().get(cat)
        if current is not None and current != self._router_set_window.get(cat):
            self._operator_window_caps[cat] = current
        return self._operator_window_caps.get(cat, self.executor.pipeline_depth)

    # -- the loop-closer -------------------------------------------------------
    def replan(self, spec=None,
               extra_profiles: tuple[CategoryProfile, ...] = (),
               apply: bool = True, max_batch: int | None = None,
               deadline_s: float | None = None) -> OffloadPlan:
        """Re-derive the plan from the executor's measured telemetry.

        By default pricing batches at the *observed* queue occupancy
        (capped by the adaptively chosen per-category ceiling): traffic
        that arrived one call per flush gets no handshake amortization
        credit, traffic that arrived in deep groups does — so the plan's
        verdict matches how this runtime actually executed.  Pass
        ``max_batch=1`` for the paper's serial model, or an explicit value
        to price a hypothetical batching depth (explicit values disable
        adaptation).

        Adaptive batching + sharding + tiling: when ``max_batch`` is
        omitted, the router also *sets* the executor's per-category
        coalescing ceilings, sharded device fan-outs AND memory-budgeted
        tile depths to :meth:`choose_sharding`'s ``(max_batch, n_devices,
        tile_k)`` picks (observed traffic + optional ``deadline_s``
        latency bound) as part of ``apply`` — the caps stop being fixed
        constructor arguments and follow the workload.  The per-engine
        pipeline windows follow too: :meth:`choose_windows` collapses a
        category's window to its observed in-flight occupancy so the
        modeled pipelined hiding matches the overlap the traffic actually
        achieved.

        Fidelity gating: when the executor shadows offloaded batches
        (``fidelity=``), each profile carries the checker's worst observed
        ``rel_err`` for its category into ``plan_offload``, which vetoes
        offload for categories whose error exceeds the converters' ENOB
        budget *regardless of speedup* (``OffloadDecision.fidelity_bound``).
        Applying such a plan routes the degraded category back to the host
        — the profile -> plan -> execute -> re-profile loop now closes over
        accuracy as well as time.

        ``extra_profiles`` lets callers append workload the runtime never
        saw (e.g. a known non-offloadable phase); ``apply=False`` prices
        without touching the routing table or the executor's ceilings.
        """
        telemetry = self.executor.telemetry
        tracer = getattr(self.executor, "tracer", None)
        if tracer is not None:
            # modeled-vs-measured attribution for the traffic this replan
            # prices: the worst-drifting stage names where the cost model
            # and the measured runtime disagree most
            rep = drift_report(tracer.spans())
            self.drift = rep if rep.invocations else None
        profiles = list(telemetry.profiles())
        profiles.extend(extra_profiles)
        checker = self.executor.fidelity
        if checker is not None:
            profiles = [
                dataclasses.replace(p, rel_err=w.rel_err)
                if (w := checker.worst(p.name)) is not None else p
                for p in profiles
            ]
        chosen: dict[str, tuple[int, int, int]] | None = None
        if max_batch is None:
            chosen = self.choose_sharding(deadline_s)
            # price at what the traffic achieved, bounded by the adaptive
            # ceiling: one category's deep batches must not credit another
            # category's serial traffic with amortization
            batch: int | dict[str, int] = {
                cat: min(chosen[cat][0], telemetry.observed_occupancy(cat))
                for cat in telemetry.categories()}
        else:
            batch = max_batch
        # the gate must judge with the checker's own slack, or the plan's
        # fidelity verdicts disagree with the checker's VIOLATION reports
        gate_kw = {} if checker is None \
            else {"fidelity_slack": checker.slack}
        plan = plan_offload(profiles, spec or self.executor.spec,
                            max_batch=batch, **gate_kw)
        if apply:
            self.apply(plan)
            if chosen is not None:
                for cat, (k, n, t) in chosen.items():
                    self.executor.set_max_batch(cat, k)
                    self._router_set[cat] = k
                    self.executor.set_n_devices(cat, n)
                    self._router_set_dev[cat] = n
                    self.executor.set_tile_k(cat, t)
                    self._router_set_tile[cat] = t
                for cat, w in self.choose_windows().items():
                    self.executor.set_pipeline_window(cat, w)
                    self._router_set_window[cat] = w
        return plan

    def summary(self) -> str:
        rows = ["router: " + ", ".join(
            f"{c}->{b}" for c, b in sorted(self.routes.items()))]
        if self.drift is not None and self.drift.worst is not None:
            w = self.drift.worst
            rows.append(
                f"  drift: worst stage '{w.stage}' measured/modeled="
                f"{w.drift:.3g} over {self.drift.invocations} traced "
                f"invocations")
        if self.plan is not None:
            rows.append(self.plan.summary())
        return "\n".join(rows)
