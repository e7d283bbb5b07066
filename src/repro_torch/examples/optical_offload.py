"""Run a CNN workload through the conversion-aware offload runtime.

The twin of the reference's ``examples/optical_offload.py``, on the CUDA
card, in the same ten steps:

  1. profile   — serve the conv workload through the runtime's host backend;
                 telemetry measures per-category time and boundary traffic;
  2. plan      — ``PlanRouter.replan()`` prices the measured profiles on the
                 prototype 4f engine (the conversion boundary loses, the
                 paper's conclusion) and on a batched column-parallel
                 variant, with adaptive coalescing ceilings and a latency
                 ``deadline_s`` capping how deep batching may go;
  3. execute   — apply the plan: conv traffic routes through the simulated
                 optical engine, same-shape calls coalesce into ONE batched
                 invocation each, and ``flush_async`` double-buffers the
                 boundary;
  4. verify    — every offloaded batch is shadowed by the host reference and
                 scored against the converters' ENOB budget;
  5. scale out — the same flush group scatters across four replicated
                 simulated apertures (``n_devices=4``, the ``sharded``
                 backend); the modeled invocation wall drops to
                 max-over-devices + sync;
  6. trickle   — a sparse Poisson arrival stream through the
                 admission-controlled ``OffloadScheduler`` against
                 drain-on-flush, on a ``ManualClock``;
  7. tile      — 512x512 frames under the detected memory budget
                 (L2-derived on the card): ``replan`` picks ``tile_k`` and
                 the group streams as tile-sized sub-invocations;
  8. observe   — the opt-in span tracer: a trace digest, wall percentiles
                 and the modeled-vs-measured drift table;
  9. survive   — a seeded ``ChaosBackend`` (10 % of dispatches fault):
                 every frame retires, in order, within the error budget;
  10. reuse    — the operand residency cache: a repeat flush skips the
                 write-side DAC crossing (``cost.dac_s == 0``), bit-equal
                 to the re-staged path.

Each step is a function that prints and returns its numbers.  Frames
and kernels come from seeded ``numpy.random.default_rng`` streams (one
per key of the reference's ``jax.random`` draws: 0 for the images,
``100 + i`` for the conv kernels, 42, 7 and 11 for steps 6, 9 and 10).

Run:  PYTHONPATH=src python -m repro_torch.examples.optical_offload
      [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from repro_torch.core import PROTOTYPE_4F
from repro_torch.runtime import (
    BATCHED_4F,
    CONV_CAPTURES,
    FidelityChecker,
    ManualClock,
    MemoryBudget,
    OffloadExecutor,
    OffloadScheduler,
    PlanRouter,
    Tracer,
    drift_report,
    enob_error_bound,
    register_chaos,
    summarize,
)

SIDE = 512
IMAGES = 8


def _frames(n: int, shape, seed: int, device) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.random(shape, dtype=np.float32), device=device)
            for _ in range(n)]


def _tap_kernel(shape, taps: int, scale: float, seed: int,
                device) -> torch.Tensor:
    """``taps`` x ``taps`` normal taps of ``scale`` around a 0.5 identity
    center, zero elsewhere."""
    k = np.zeros(shape, np.float32)
    rng = np.random.default_rng(seed)
    k[:taps, :taps] = scale * rng.standard_normal((taps, taps),
                                                  dtype=np.float32)
    k[0, 0] += 0.5
    return torch.tensor(k, device=device)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.norm(got - want)
                 / torch.clamp(torch.linalg.norm(want), min=1e-12))


def inputs(device="cuda") -> tuple[list[torch.Tensor], list[torch.Tensor]]:
    """Eight 512x512 images and the three layers' kernels.

    512x512 frames: the regime where the host FFT costs real time and 8
    inputs still pack into one 2048x2048 SLM frame.  5x5 taps around an
    identity center keep each layer's output norm comparable to its input.
    """
    imgs = _frames(IMAGES, (SIDE, SIDE), 0, device)
    kernels = [_tap_kernel((SIDE, SIDE), 5, 0.04, 100 + i, device)
               for i in range(3)]
    return imgs, kernels


def conv_stack(router: PlanRouter, imgs, kernels) -> list[torch.Tensor]:
    """3-layer circular-conv + relu stack over a batch of images.

    Convolutions go through the router (host or optical per the current
    plan); the nonlinearities stay on the host — the paper's §3 point that
    inter-layer nonlinearity forces a conversion round trip per layer.
    """
    outs = list(imgs)
    for k in kernels:
        handles = [router.submit("conv", x, kernel=k) for x in outs]
        router.executor.flush_async()        # batched + double-buffered
        outs = [torch.relu(h.wait().value) for h in handles]
    return outs


def run_plan_demo(executor: OffloadExecutor, imgs, kernels) -> dict:
    """Steps 1-4: profile, plan, execute, verify."""
    router = PlanRouter(executor)            # starts all-host: profiling mode

    # --- 1. profile: measured traffic, no hand-written numbers --------------
    executor.warm("conv", imgs[0], kernel=kernels[0], backend="host",
                  batch=len(imgs))
    executor.telemetry.start()
    host_out = conv_stack(router, imgs, kernels)
    executor.telemetry.stop()
    print(executor.telemetry.summary())

    # --- 2. plan: price the observed workload, adapt the batching ------------
    proto_plan = router.replan(spec=PROTOTYPE_4F, apply=False, max_batch=1)
    proto_offload = any(d.offload for d in proto_plan.decisions)
    print("\n-- measured plan on the paper's prototype (Fig. 8 links) --")
    print(proto_plan.summary())
    print("paper's conclusion, reproduced from *measured* traffic: "
          f"offload chosen = {proto_offload}")

    print("\n-- adaptive per-category coalescing ceilings --")
    unconstrained = router.choose_max_batch()
    print(f"unconstrained: {unconstrained}")
    n_in, _ = executor.telemetry.samples_per_call("conv")
    tight = dataclasses.replace(
        BATCHED_4F, phase_shift_captures=CONV_CAPTURES).batched_step_cost(
            n_in, batch=4, pipeline_depth=2).total_s
    constrained = router.choose_max_batch(deadline_s=tight)
    print(f"deadline {tight * 1e3:.1f} ms: {constrained}")

    plan = router.replan()                   # batched-4f spec; applies routes
    print("\n-- measured plan on the batched column-parallel variant --")
    print(plan.summary())
    print(f"routes now: {router.routes}  "
          f"max_batch now: {dict(executor.category_max_batches())}")

    # --- 3. execute the plan: conv through the optical engine ----------------
    opt_out = conv_stack(router, imgs, kernels)
    rel = max(_rel(o, h) for h, o in zip(host_out, opt_out))
    out = {"prototype_offload": proto_offload,
           "max_batch_unconstrained": unconstrained,
           "deadline_s": tight, "max_batch_at_deadline": constrained,
           "plan_speedup": plan.end_to_end_speedup,
           "routes": dict(router.routes), "stack_rel_err": rel}
    conv_stats = executor.telemetry.stats.get(("conv", "optical-sim"))
    if conv_stats is not None:
        per_call = conv_stats.modeled.scaled(1.0 / max(conv_stats.calls, 1))
        single = dataclasses.replace(
            BATCHED_4F, phase_shift_captures=CONV_CAPTURES).step_cost(
                SIDE * SIDE)
        out.update(
            boundary_s_per_call=per_call.conversion_s + per_call.interface_s,
            unbatched_boundary_s=single.conversion_s + single.interface_s,
            optical_calls=conv_stats.calls,
            optical_invocations=conv_stats.invocations)
        print(f"\nbatched boundary cost/call: conv+interface "
              f"{out['boundary_s_per_call']:.4g}s (unbatched would pay "
              f"{out['unbatched_boundary_s']:.4g}s) — {conv_stats.calls} "
              f"calls in {conv_stats.invocations} batched invocations")

    # --- 4. verify: the accuracy cost of the speedup --------------------------
    print(f"\nend-to-end stack divergence vs host: rel error {rel:.4f}")
    print(executor.fidelity.summary())
    out["fidelity_ok"] = executor.fidelity.all_ok
    return out


def run_sharded_demo(imgs, kernels, device="cuda") -> dict:
    """Step 5: one group scattered over 4 replicated apertures."""
    # unlimited budget: sharding's claim is ONE invocation scattered whole
    # across the fleet (step 7 owns the tiling story)
    with OffloadExecutor(BATCHED_4F, max_batch=16, n_devices=4,
                         default_backend="sharded",
                         mem_budget=MemoryBudget.unlimited(),
                         device=device) as sharded:
        sharded.warm("conv", imgs[0], kernel=kernels[0], batch=len(imgs))
        handles = [sharded.submit("conv", im, kernel=kernels[0])
                   for im in imgs]
        sharded.flush()
        # runtime-equivalence invariant: sharded == host reference
        kf = torch.fft.fft2(kernels[0])
        ref = [torch.fft.ifft2(torch.fft.fft2(im) * kf).real for im in imgs]
        rel_sh = max(_rel(h.value, r) for h, r in zip(handles, ref))
        sharded_total = sum(h.cost.total_s for h in handles)
        single_total = dataclasses.replace(
            BATCHED_4F, phase_shift_captures=CONV_CAPTURES).batched_step_cost(
                SIDE * SIDE, batch=len(imgs), pipeline_depth=2).total_s
        print("\n-- sharded offload: 4 replicated apertures, group sharding --")
        per_dev = sharded.telemetry.device_samples("conv")
        for d, (s_in, s_out) in per_dev.items():
            print(f"  device {d}: {s_in} samples through its DAC, "
                  f"{s_out} back through its ADC")
        print(f"sharded-vs-host rel error {rel_sh:.4f} (equivalence invariant)")
        print(f"modeled invocation wall: sharded {sharded_total:.4g}s "
              f"(max-over-devices + sync) vs single-device {single_total:.4g}s "
              f"-> {single_total / sharded_total:.3f}x")
    return {"device_samples": dict(per_dev), "rel_err": rel_sh,
            "sharded_modeled_s": sharded_total,
            "single_modeled_s": single_total}


def run_trickle_demo(rate_hz: float = 200.0, deadline_s: float = 0.05,
                     arrivals: int = 24, device="cuda") -> dict:
    """Step 6: admission-controlled continuous batching vs drain-on-flush
    under a Poisson stream too sparse to fill a batch between flushes; a
    ``ManualClock`` drives the arrivals, so the occupancy is
    deterministic."""
    frames = _frames(arrivals, (128, 128), 42, device)
    print(f"\n-- trickle arrivals ({rate_hz:.0f}/s Poisson, "
          f"{deadline_s * 1e3:.0f} ms hold deadline) --")
    out = {}
    for held in (False, True):
        rng = np.random.RandomState(0)       # same trace for both regimes
        clk = ManualClock()
        with OffloadExecutor(BATCHED_4F, max_batch=8, clock=clk,
                             device=device) as ex:
            ex.warm("fft", frames[0])
            sched = OffloadScheduler(ex, deadline_s=deadline_s, clock=clk) \
                if held else None
            for frame in frames:
                clk.advance(float(rng.exponential(1.0 / rate_hz)))
                if held:
                    sched.submit("fft", frame)   # polls: holds or releases
                else:
                    ex.submit("fft", frame)
                    ex.flush()                   # drain-on-flush baseline
        st = ex.telemetry.stats[("fft", "optical-sim")]
        per_call = st.modeled.scaled(1.0 / st.calls)
        label = "scheduler-held" if held else "drain-on-flush"
        out[label] = {
            "calls": st.calls, "invocations": st.invocations,
            "occupancy": st.calls / st.invocations,
            "boundary_s_per_call": per_call.conversion_s + per_call.interface_s,
            "hold_s_per_call": per_call.hold_s,
            "modeled_s_per_call": per_call.total_s}
        r = out[label]
        print(f"  {label:>15}: {st.calls} calls in {st.invocations} "
              f"crossings (occupancy {r['occupancy']:.2f}), "
              f"boundary {r['boundary_s_per_call']:.4g}s"
              f"/call, hold {r['hold_s_per_call']:.4g}s/call, "
              f"modeled wall {r['modeled_s_per_call']:.4g}s/call")
    return out


def run_tiled_demo(imgs, device="cuda") -> dict:
    """Step 7: memory-budgeted tiled dispatch of a 512x512 group under the
    budget detected for the executor's device."""
    budget = MemoryBudget.detect(device)
    print(f"\n-- large frames: memory-budgeted tiled dispatch "
          f"({budget.bytes_limit // (1024 * 1024)} MiB {budget.source} "
          f"budget, reserve {budget.reserve:.0%}) --")
    with OffloadExecutor(BATCHED_4F, max_batch=16, mem_budget=budget,
                         device=device) as ex:
        router = PlanRouter(ex)              # all-host profiling mode
        ex.warm("fft", imgs[0], backend="host", batch=len(imgs))
        ex.telemetry.start()
        for h in [router.submit("fft", im) for im in imgs]:
            h.get()
        ex.telemetry.stop()
        router.replan()                      # picks (max_batch, n_devices, tile_k)
        k, _n, t = router.choose_sharding()["fft"]
        print(f"replan chose max_batch={k}, tile_k={t} for 512x512 fft "
              f"(monolithic would stage "
              f"{k * 2 * SIDE * SIDE * 4 // (1024 * 1024)} MiB + "
              f"intermediates)")
        n_in, n_out = ex.telemetry.samples_per_call("fft")
        mono = BATCHED_4F.batched_step_cost(n_in, n_out, batch=k,
                                            pipeline_depth=2)
        tiled = BATCHED_4F.batched_step_cost(n_in, n_out, batch=k,
                                             pipeline_depth=2, tile_k=t)
        print(f"modeled invocation wall: tiled {tiled.total_s:.4g}s vs "
              f"monolithic {mono.total_s:.4g}s — the boundary model prices "
              f"each tile's own handshake/settle; the benchmark's "
              f"large_frame row measures the walls")
        # one group through the simulated engine on fresh telemetry, so
        # the tile counts are the optical dispatches alone
        ex.telemetry.reset()
        ex.warm("fft", imgs[0], batch=len(imgs))
        for h in [ex.submit("fft", im, backend="optical-sim")
                  for im in imgs]:
            h.get()
        tiles = ex.telemetry.tile_sizes_observed("fft")
        per_frame = ex.telemetry.bytes_per_frame("fft")
        print(f"dispatched tile sizes (telemetry): {tiles} — measured "
              f"{per_frame // 1024} KiB/frame staged")
    return {"budget_bytes": budget.bytes_limit,
            "budget_source": budget.source, "max_batch": k, "tile_k": t,
            "tiled_modeled_s": tiled.total_s,
            "monolithic_modeled_s": mono.total_s,
            "dispatched_tile_sizes": dict(tiles),
            "bytes_per_frame": per_frame}


def run_traced_demo(imgs, kernels, device="cuda") -> dict:
    """Step 8: one flush group traced, boundary-attributed."""
    tracer = Tracer()
    with OffloadExecutor(BATCHED_4F, max_batch=16, tracer=tracer,
                         mem_budget=MemoryBudget.unlimited(),
                         device=device) as ex:
        ex.warm("conv", imgs[0], kernel=kernels[0], batch=len(imgs))
        ex.telemetry.start()
        for h in [ex.submit("conv", im, kernel=kernels[0]) for im in imgs]:
            h.get()
        ex.telemetry.stop()
        spans = tracer.spans()
        print("\n-- traced: one flush group, boundary-attributed --")
        print(summarize(spans))
        pct = ex.telemetry.percentiles("conv")
        print("conv wall percentiles: " + "  ".join(
            f"p{int(p)}={v * 1e3:.2f}ms" for p, v in pct.items()))
        report = drift_report(spans)
        print("\nmodeled-vs-measured drift (per stage):")
        print(report.table())
    return {"spans": len(spans), "wall_percentiles_s": dict(pct),
            "drift": report.to_json()}


def run_chaos_demo(calls: int = 32, rate: float = 0.10,
                   device="cuda") -> dict:
    """Step 9: fault-injected offload under the retry/quarantine policy;
    every frame retires, in submit order, within the ENOB error budget."""
    frames = _frames(calls, (64, 64), 7, device)
    chaos = register_chaos("optical-sim", name="chaos-demo",
                           rate=rate, seed=2)
    clk = ManualClock()
    with OffloadExecutor(BATCHED_4F, default_backend=chaos, max_batch=4,
                         clock=clk, fidelity=FidelityChecker(),
                         device=device) as ex:
        ex.warm("fft", frames[0])
        handles = [ex.submit("fft", f) for f in frames]
    with OffloadExecutor(BATCHED_4F, default_backend="host",
                         max_batch=1, device=device) as host:
        refs = [host.submit("fft", f) for f in frames]
    enob = min(BATCHED_4F.dac.effective_bits, BATCHED_4F.adc.effective_bits)
    bound = enob_error_bound(enob, 16.0)
    worst = max(_rel(h.value, r.value) for h, r in zip(handles, refs))
    served = sorted({h.backend for h in handles})
    retired = all(h.ready for h in handles)
    print(f"\n-- chaos: {rate:.0%} injected fault rate over {calls} calls --")
    print(ex.telemetry.summary())
    print(f"served by {served}; all retired: {retired}; worst rel error "
          f"{worst:.2e} (ENOB bound {bound:.2e}) -> within budget: "
          f"{worst <= bound}")
    print(ex.quarantine.summary(ex.now()))
    return {"served_by": served, "all_retired": retired,
            "worst_rel_err": worst, "enob_bound": bound,
            "faults_total": ex.telemetry.faults_total("fft")}


def run_residency_demo(calls: int = 8, device="cuda") -> dict:
    """Step 10: serve a conv layer's frames twice through the residency
    cache; the second flush pays no write-side DAC and is bit-equal to a
    residency-off executor."""
    imgs = _frames(calls, (128, 128), 11, device)
    kernel = _tap_kernel((128, 128), 3, 0.05, 99, device)

    with OffloadExecutor(BATCHED_4F, max_batch=calls, residency=True,
                         device=device) as ex:
        first = [ex.submit("conv", x, kernel=kernel) for x in imgs]
        ex.flush()
        second = [ex.submit("conv", x, kernel=kernel) for x in imgs]
        ex.flush()
        hit_rate = ex.telemetry.residency_hit_rate("conv")
        ledger = ex.residency.summary()
    with OffloadExecutor(BATCHED_4F, max_batch=calls, device=device) as plain:
        refs = [plain.submit("conv", x, kernel=kernel) for x in imgs]

    bit_equal = all(torch.equal(s.value, r.value)
                    for s, r in zip(second, refs))
    print(f"\n-- residency: serve {calls} conv frames twice, "
          f"pay the DAC once --")
    print(f"first flush  (cold): dac {first[0].cost.dac_s * 1e6:8.2f}us/call "
          f"total {first[0].cost.total_s * 1e6:8.2f}us/call")
    print(f"second flush (hit):  dac {second[0].cost.dac_s * 1e6:8.2f}us/call "
          f"total {second[0].cost.total_s * 1e6:8.2f}us/call")
    print(f"hit rate {hit_rate:.0%}; bit-equal to residency-off: {bit_equal}")
    print(ledger)
    return {"cold_dac_s": first[0].cost.dac_s,
            "hit_dac_s": second[0].cost.dac_s, "hit_rate": hit_rate,
            "bit_equal": bit_equal}


def run(device="cuda") -> dict:
    """All ten steps; returns each demo's numbers by name."""
    imgs, kernels = inputs(device)
    # the budget is pinned to unlimited for steps 1-4 (one monolithic
    # invocation per group); step 7 turns the detected budget on
    with OffloadExecutor(BATCHED_4F, fidelity=FidelityChecker(),
                         max_batch=16, pipeline_depth=2,
                         mem_budget=MemoryBudget.unlimited(),
                         device=device) as executor:
        plan = run_plan_demo(executor, imgs, kernels)
    return {"plan": plan,
            "sharded": run_sharded_demo(imgs, kernels, device=device),
            "trickle": run_trickle_demo(device=device),
            "tiled": run_tiled_demo(imgs, device=device),
            "traced": run_traced_demo(imgs, kernels, device=device),
            "chaos": run_chaos_demo(device=device),
            "residency": run_residency_demo(device=device)}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("repro_torch.examples.optical_offload: no CUDA card available "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return 2
    run(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
