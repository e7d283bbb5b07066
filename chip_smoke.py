"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version on the card, runs the main path
(16 frames of 512x512 through ``OffloadExecutor`` + ``PlanRouter`` on the
``optical-sim`` backend, spec ``BATCHED_4F``) with every kernel's launch
count set to 0 just before and read just after, runs the 3-layer 512x512
conv stack, times each kernel beside its plain version, a library call and
its bound, and prints as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the exit code is non-zero and no result line
is printed.  Without a CUDA card it exits with code 2.

It imports ``torch``, numpy and ``repro_torch`` only.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
FRAMES = 16          # one flush group: 16 frames tiled onto the 2048^2 SLM
SIDE = 512           # frame side, as examples/optical_offload.py runs it
TIMED_RUNS = 21      # CUDA-event samples per timing (median reported)

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores
# and HBM3 bandwidth.  The kernels run fp32 FMA on the CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

SOURCE = "src/repro_torch/csrc/optical_dft.cu"
REPLACES = {
    "dft_stage1_batched": "src/repro/kernels/optical_dft.py:176",
    "dft_stage2_batched": "src/repro/kernels/optical_dft.py:305",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rng_frames(rng: np.random.Generator, shape, dev) -> torch.Tensor:
    return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)


def max_violation(got: torch.Tensor, want: torch.Tensor, rtol: float,
                  atol: float) -> float:
    """max(|got - want| - (atol + rtol |want|)); <= 0 means within bounds."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


# --- phase 2: kernels against their plain versions ---------------------------


def stage_inputs(od, rng, batch, m, k, n, dev):
    """W (m, k) from the unitary factors of size k (rows repeated when
    m > k), A (batch, k, n) uniform in [0, 1)."""
    wr, wi = od.dft_matrix_factors(k, device=dev)
    reps = -(-m // k)
    wr, wi = wr.repeat(reps, 1)[:m].contiguous(), \
        wi.repeat(reps, 1)[:m].contiguous()
    return wr, wi, rng_frames(rng, (batch, k, n), dev)


def check_stage1(od, rng, shape, dev, dac_bits=8, a=None):
    batch, m, k, n = shape
    wr, wi, a0 = stage_inputs(od, rng, batch, m, k, n, dev)
    a = a0 if a is None else a
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=dac_bits)
    pr, pi = od.dft_stage1_batched_plain(wr, wi, a, dac_bits=dac_bits)
    torch.cuda.synchronize()
    v = max(max_violation(tr, pr, 1e-4, 1e-5),
            max_violation(ti, pi, 1e-4, 1e-5))
    err = max(float((tr - pr).abs().max()), float((ti - pi).abs().max()))
    check(v <= 0.0, f"stage 1 {shape} dac_bits={dac_bits}: "
          f"max |err| {err:.3e} outside rtol 1e-4 / atol 1e-5")
    return err


def check_stage2(od, rng, shape, dev):
    batch, m, k, n = shape
    wr, wi = od.dft_matrix_factors(k, device=dev)
    reps = -(-n // k)
    wr, wi = wr.repeat(reps, 1)[:n].contiguous(), \
        wi.repeat(reps, 1)[:n].contiguous()
    tr = rng_frames(rng, (batch, m, k), dev)
    ti = rng_frames(rng, (batch, m, k), dev)
    got = od.dft_stage2_batched(tr, ti, wr, wi)
    want = od.dft_stage2_batched_plain(tr, ti, wr, wi)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(max_violation(got, want, 1e-4, 1e-4 * float(want.max())) <= 0.0,
          f"stage 2 {shape}: max |err| {err:.3e} outside rtol 1e-4 / "
          "atol 1e-4*max")
    return err


def check_pipeline(od, rng, shape, dev, dac_bits):
    """Both kernels against the fft2 oracle, frame by frame."""
    a = rng_frames(rng, shape, dev)
    got = od.optical_dft2_intensity_batched(a, dac_bits=dac_bits)
    q = a
    if dac_bits:
        levels = (1 << dac_bits) - 1
        q = torch.round(torch.clamp(a, 0.0, 1.0) * levels) / levels
    want = torch.fft.fft2(q.to(torch.complex64), norm="ortho").abs() ** 2
    torch.cuda.synchronize()
    for i in range(shape[0]):
        check(max_violation(got[i], want[i], 2e-4,
                            2e-4 * float(want[i].max())) <= 0.0,
              f"pipeline {shape} dac_bits={dac_bits} frame {i} outside "
              "rtol 2e-4 / atol 2e-4*max of fft2")


def phase_kernels(od, dev, tile_k: int) -> dict[str, float]:
    rng = np.random.default_rng(SEED)
    main = (FRAMES, SIDE, SIDE, SIDE)
    shapes = [main, (tile_k, SIDE, SIDE, SIDE), (5, 64, 64, 64),
              (1, 8, 256, 128), (3, 128, 128, 256)]
    err = {"dft_stage1_batched": 0.0, "dft_stage2_batched": 0.0}
    for shape in shapes:
        e1 = check_stage1(od, rng, shape, dev)
        e2 = check_stage2(od, rng, shape, dev)
        if shape == main:
            err = {"dft_stage1_batched": e1, "dft_stage2_batched": e2}
        print(f"  stage 1/2 {shape}: max |err| {e1:.3e} / {e2:.3e}")
    for shape in [(FRAMES, SIDE, SIDE), (5, 64, 64), (3, 128, 256),
                  (1, 8, 128)]:
        for bits in (0, 8):
            check_pipeline(od, rng, shape, dev, bits)
    print("  pipeline vs fft2: ok at dac_bits 0 and 8")
    # DAC ties: round half to even, as torch.round does.  0.5 at 8 bits is
    # the tie 127.5; 0.49607843 is the tie 126.5 (even 126, away 127).
    for value, bits in ((0.5, 8), (0.4960784316062927, 8), (0.5, 1)):
        a = torch.full((1, 64, 64), value, dtype=torch.float32, device=dev)
        check_stage1(od, rng, (1, 64, 64, 64), dev, dac_bits=bits, a=a)
    print("  DAC ties (0.5 @ 8 b, 126.5/255 @ 8 b, 0.5 @ 1 b): ok")
    return err


# --- phase 3: the main path ---------------------------------------------------


def conv_stack(router, imgs, kernels):
    """The example's 3-layer circular-conv + relu stack."""
    outs = list(imgs)
    for k in kernels:
        handles = [router.submit("conv", x, kernel=k) for x in outs]
        router.executor.flush_async()
        outs = [torch.relu(h.wait().value) for h in handles]
    return outs


def phase_main_path(rt, od, dev) -> dict:
    rng = np.random.default_rng(SEED + 1)
    spec = rt.BATCHED_4F
    ex = rt.OffloadExecutor(spec, max_batch=FRAMES, pipeline_depth=2)
    check(ex.device.type == "cuda", f"executor on {ex.device}")
    router = rt.PlanRouter(ex)
    frames = [rng_frames(rng, (SIDE, SIDE), dev) for _ in range(FRAMES)]
    tile = ex.resolve_tile_k("fft", frames[0], FRAMES)
    ex.warm("fft", frames[0], backend="optical-sim", batch=FRAMES)
    ex.warm("fft", frames[0], backend="host", batch=FRAMES)
    torch.cuda.synchronize()

    od.reset_launches()
    t0 = time.perf_counter()
    handles = [router.submit("fft", x, backend="optical-sim")
               for x in frames]
    ex.flush_async()
    for h in handles:
        h.wait()
    wall_s = time.perf_counter() - t0
    launches = {"dft_stage1_batched": od.dft_stage1_batched.launches,
                "dft_stage2_batched": od.dft_stage2_batched.launches}
    print(f"  budget {ex.mem_budget}, tile_k {tile}, launches {launches}, "
          f"flush wall {wall_s * 1e3:.3f} ms")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")

    hosts = [ex.submit("fft", x, backend="host") for x in frames]
    ex.flush()
    adc_levels = (1 << spec.adc.bits) - 1
    for i, (h, r) in enumerate(zip(handles, hosts)):
        got, want = h.value, r.value
        check(got.shape == (SIDE, SIDE) and bool(torch.isfinite(got).all()),
              f"frame {i}: shape {tuple(got.shape)} or non-finite values")
        top = float(want.max())
        bound = 2e-4 * top + float(got.max()) / adc_levels
        err = float((got - want).abs().max())
        check(err <= bound, f"frame {i}: |optical - host| {err:.3e} > "
              f"{bound:.3e} (2e-4*max + one 14-bit ADC step)")
        check(h.backend == "optical-sim", f"frame {i} served by {h.backend}")
    checker = rt.FidelityChecker()
    enob = min(spec.dac.effective_bits, spec.adc.effective_bits)
    report = checker.check("fft", "optical-sim", [h.value for h in handles],
                           [r.value for r in hosts], enob=enob)
    print(f"  {report}")
    check(report.ok, "fft fidelity outside the ENOB bound")

    n = SIDE * SIDE
    for h in handles:
        want = spec.batched_step_cost(n, n, batch=h.batch, pipeline_depth=2,
                                      resident_frames=0, delta_fractions=())
        check(h.batch == tile, f"invocation of {h.batch} frames, tile {tile}")
        check(h.cost == want.scaled(1.0 / h.batch),
              "StepCost differs from batched_step_cost at the tile")
    group = spec.batched_step_cost(n, n, batch=FRAMES, pipeline_depth=2,
                                   tile_k=tile)
    print(f"  StepCost per invocation == batched_step_cost(batch={tile}); "
          f"modeled tiled group wall {group.total_s * 1e3:.4f} ms")

    def flush() -> float:
        t0 = time.perf_counter()
        hs = [router.submit("fft", x, backend="optical-sim") for x in frames]
        ex.flush_async()
        for h in hs:
            h.wait()
        return (time.perf_counter() - t0) * 1e3

    walls = [flush() for _ in range(9)]  # repeat flushes, not counted
    profiled = profile_flush(flush)
    ex.close()
    return {"launches": launches, "tile_k": tile,
            "budget_bytes": ex.mem_budget.bytes_limit,
            "budget_source": ex.mem_budget.source,
            "flush_wall_ms": wall_s * 1e3,
            "repeat_flush_wall_ms": walls,
            "repeat_flush_wall_median_ms": statistics.median(walls),
            "profiled_flush": profiled}


def profile_flush(flush) -> dict:
    """One flush under torch.profiler: device busy time by kernel name
    against the flush's wall (both in ms)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = flush()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms if wall_ms else None,
           "top": [{"name": e.key[:60], "count": e.count,
                    "ms": e.self_device_time_total / 1e3} for e in top]}
    print(f"  profiled flush: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms" + ("" if busy_ms else " (profiler reported no "
                                "device time: not measured)"))
    for t in out["top"]:
        print(f"    {t['ms']:.4f} ms x{t['count']}  {t['name']}")
    return out


def phase_conv_stack(rt, dev) -> None:
    rng = np.random.default_rng(SEED + 2)
    imgs = [rng_frames(rng, (SIDE, SIDE), dev) for _ in range(8)]
    kernels = []
    for _ in range(3):
        k = np.zeros((SIDE, SIDE), np.float32)
        k[:5, :5] = 0.04 * rng.standard_normal((5, 5)).astype(np.float32)
        k[0, 0] += 0.5
        kernels.append(torch.from_numpy(k).to(dev))
    checker = rt.FidelityChecker()
    with rt.OffloadExecutor(rt.BATCHED_4F, fidelity=checker, max_batch=16,
                            pipeline_depth=2) as ex:
        router = rt.PlanRouter(ex)
        router.routes["conv"] = "optical-sim"
        outs = conv_stack(router, imgs, kernels)
    check(all(o.shape == (SIDE, SIDE) and bool(torch.isfinite(o).all())
              for o in outs), "conv stack output shape / finiteness")
    invocations = ex.telemetry.stats[("conv", "optical-sim")].invocations
    check(len(checker.reports) == invocations >= 3,
          f"{len(checker.reports)} fidelity reports for {invocations} "
          "conv invocations")
    print("  " + checker.summary().replace("\n", "\n  "))
    check(checker.all_ok, "conv stack fidelity outside the ENOB bound")


# --- phase 4: times -------------------------------------------------------------


def stage_work(od, dev, b: int) -> dict:
    """Each kernel, its plain version and one complex64 ``torch.matmul``
    computing the same stage, on (b, 512, 512) inputs, with the stage's
    operation and byte counts."""
    rng = np.random.default_rng(SEED + 3)
    m = k = n = SIDE
    wr, wi = od.dft_matrix_factors(k, device=dev)
    a = rng_frames(rng, (b, k, n), dev)
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=8)
    q = torch.round(torch.clamp(a, 0.0, 1.0) * 255) / 255
    wc, qc, tc = torch.complex(wr, wi), q.to(torch.complex64), \
        torch.complex(tr, ti)
    f4 = 4  # bytes per float32
    return {
        "dft_stage1_batched": dict(
            kernel=lambda: od.dft_stage1_batched(wr, wi, a, dac_bits=8),
            plain=lambda: od.dft_stage1_batched_plain(wr, wi, a, dac_bits=8),
            library=lambda: torch.matmul(wc, qc),
            flops=4 * b * m * k * n,
            bytes=f4 * (2 * m * k + b * k * n + 2 * b * m * n)),
        "dft_stage2_batched": dict(
            kernel=lambda: od.dft_stage2_batched(tr, ti, wr, wi),
            plain=lambda: od.dft_stage2_batched_plain(tr, ti, wr, wi),
            library=lambda: torch.matmul(tc, wc.T),
            flops=8 * b * m * k * n + 3 * b * m * n,
            bytes=f4 * (2 * b * m * k + 2 * n * k + b * m * n)),
    }


def phase_times(od, dev, main: dict, errs: dict[str, float]) -> list[dict]:
    tile = main["tile_k"]
    at_tile = stage_work(od, dev, tile)
    rows = []
    for name, w in stage_work(od, dev, FRAMES).items():
        # alternate kernel and plain so drift hits both alike
        ms = [median_ms(w["kernel"]), median_ms(w["plain"]),
              median_ms(w["plain"]), median_ms(w["kernel"])]
        kernel_ms = statistics.mean((ms[0], ms[3]))
        plain_ms = statistics.mean((ms[1], ms[2]))
        library_ms = median_ms(w["library"])
        tile_ms = median_ms(at_tile[name]["kernel"])
        t_ops = w["flops"] / PEAK_FP32_FLOPS * 1e3
        t_bytes = w["bytes"] / PEAK_BYTES_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": main["launches"][name],
            "max_abs_err": errs[name],
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "shape": [FRAMES, SIDE, SIDE, SIDE],
            "tflops": w["flops"] / (kernel_ms * 1e-3) / 1e12,
            "ms_at_tile": tile_ms,
            "tile_shape": [tile, SIDE, SIDE, SIDE],
        })
        print(f"  {name} ({FRAMES}, {SIDE}, {SIDE}, {SIDE}): kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{library_ms:.4f} ms, bound {max(t_ops, t_bytes):.4f} ms, "
              f"launches/flush {main['launches'][name]}, "
              f"{tile_ms:.4f} ms per launch at batch {tile}")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import optical_dft as od
    import repro_torch.runtime as rt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    print("phase 1: build")
    print(f"  {card}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"  nvcc build {time.perf_counter() - t0:.2f} s")
    print("  " + build.build_log("optical_dft").strip().replace("\n", "\n  "))

    budget = rt.MemoryBudget.detect(dev)
    tile_k = budget.tile_for_group(SIDE * SIDE, SIDE * SIDE, FRAMES,
                                   pipeline_depth=2)
    print("phase 2: kernels against their plain versions")
    errs = phase_kernels(od, dev, tile_k)

    print("phase 3: main path")
    main_run = phase_main_path(rt, od, dev)
    phase_conv_stack(rt, dev)

    print("phase 4: times")
    rows = phase_times(od, dev, main_run, errs)
    print(json.dumps({"main_path": main_run}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
