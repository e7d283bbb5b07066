"""The examples' twins against the reference, on the CPU.

* ``quickstart``: the numbers it prints come from ``physics``,
  ``bottleneck`` and ``decision``, held to the reference's core functions
  on the same numpy image: the optical |FFT|'s relative errors at 8, 12
  and 16 ADC bits within rtol 1e-5 (both packages compute fp32 FFTs of a
  64x64 frame in other summation orders; measured agreement ~1e-6), the
  16-bit convolution's within rtol 5e-2 (a ~5e-4 error made of 16-bit ADC
  rounding residues, a few of which flip between summation orders;
  measured 0.05-1.3 %), the Fig. 8 price and both plans equal.
* ``optical_offload``: each step returns what it prints.  The trickle
  step's report is the reference's, line for line (it is modeled prices
  on a ``ManualClock``: the frames do not enter it); the other steps are
  held to the reference's invariants.
* Both ``main(["--device", "cpu"])`` finish at the examples' real sizes,
  and both refuse to run without a card when no device is given.
"""

import dataclasses
import importlib.util
import io
import math
import os
from contextlib import redirect_stdout

import jax.numpy as jnp
import pytest
import torch

from repro.core import (IDEAL_4F, PROTOTYPE_4F, CategoryProfile,
                        OpticalSimParams, fourier_mask_for_kernel,
                        optical_conv2d, optical_fft2_magnitude, plan_offload)
from repro_torch.examples import optical_offload as texample
from repro_torch.runtime import DispatchWatchdog
from repro_torch.examples import quickstart

CPU = "cpu"


def _reference_example(name: str):
    path = os.path.join(os.path.dirname(__file__), "..", "examples",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reference_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


jexample = _reference_example("optical_offload")


def _rel(a, b) -> float:
    return float(jnp.linalg.norm(a - b) / jnp.linalg.norm(b))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quickstart_physics_matches_reference(seed):
    img = quickstart.image(seed)
    port = quickstart.physics(img, CPU)
    x = jnp.asarray(img)
    oracle = jnp.abs(jnp.fft.fft2(x, norm="ortho"))
    assert sorted(port["fft_rel_err"]) == [8, 12, 16]
    for bits, got in port["fft_rel_err"].items():
        want = _rel(optical_fft2_magnitude(
            x, OpticalSimParams(dac_bits=12, adc_bits=bits)), oracle)
        assert got == pytest.approx(want, rel=1e-5), bits
    kernel = jnp.zeros((64, 64)).at[0, 0].set(0.6).at[1, 1].set(0.4)
    blur = optical_conv2d(x, fourier_mask_for_kernel(kernel),
                          OpticalSimParams(dac_bits=12, adc_bits=16))
    ob = jnp.real(jnp.fft.ifft2(jnp.fft.fft2(x) * jnp.fft.fft2(kernel)))
    assert port["conv_rel_err"] == pytest.approx(_rel(blur, ob), rel=5e-2)
    # converter resolution is the accelerator's accuracy
    errs = port["fft_rel_err"]
    assert errs[8] > errs[12] > errs[16]


def test_quickstart_price_and_plans_match_reference():
    assert dataclasses.asdict(quickstart.bottleneck()) == \
        dataclasses.asdict(PROTOTYPE_4F.step_cost(1024 * 768))
    profiles = [
        CategoryProfile("fft", host_s=0.6, calls=10,
                        samples_in=10 * 512 * 512, samples_out=10 * 512 * 512),
        CategoryProfile("other", host_s=0.4),
    ]
    plans = quickstart.decision()
    assert list(plans) == [IDEAL_4F.name, PROTOTYPE_4F.name]
    for spec in (IDEAL_4F, PROTOTYPE_4F):
        want, got = plan_offload(profiles, spec), plans[spec.name]
        for f in ("end_to_end_speedup", "ideal_speedup", "worthwhile"):
            assert getattr(got, f) == getattr(want, f), (spec.name, f)
        assert [d.offload for d in got.decisions] == \
            [d.offload for d in want.decisions]


def test_quickstart_main_runs_on_the_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "16-bit ADC" in out and "prototype 4f" in out and "ideal-4f" in out


@pytest.mark.parametrize("main", [quickstart.main, texample.main],
                         ids=["quickstart", "optical_offload"])
def test_examples_refuse_without_a_card(monkeypatch, capsys, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main([]) == 2
    assert "no CUDA card" in capsys.readouterr().err


def test_trickle_step_prints_the_reference_s_report():
    ref, port = io.StringIO(), io.StringIO()
    with redirect_stdout(ref):
        jexample.run_trickle_demo()
    with redirect_stdout(port):
        out = texample.run_trickle_demo(device=CPU)
    assert port.getvalue() == ref.getvalue()
    held, drain = out["scheduler-held"], out["drain-on-flush"]
    assert held["calls"] == drain["calls"] == 24
    assert held["occupancy"] > drain["occupancy"] == 1.0


@pytest.fixture(scope="module")
def offload_run():
    """``optical_offload.main`` on the CPU at its real sizes, and what
    each step returned.  The straggler watchdog scores no dispatch as a
    straggler: its verdict is a host wall against a trailing median, and
    on a loaded test host it could quarantine a device or a category
    mid-step and move the counts held below (the steps on a
    ``ManualClock`` are unaffected by it either way)."""
    results = {}
    real_run = texample.run

    def recording(device):
        results.update(real_run(device))
        return results
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(texample, "run", recording)
        mp.setattr(DispatchWatchdog, "observe",
                   lambda self, key, dt_s, base_s=None: False)
        with redirect_stdout(out):
            assert texample.main(["--device", "cpu"]) == 0
    return results, out.getvalue()


def test_offload_main_runs_all_ten_steps(offload_run):
    results, out = offload_run
    assert list(results) == ["plan", "sharded", "trickle", "tiled",
                             "traced", "chaos", "residency"]
    for header in ("measured plan on the paper's prototype",
                   "adaptive per-category coalescing ceilings",
                   "sharded offload", "trickle arrivals", "large frames",
                   "traced: one flush group", "chaos:", "residency:"):
        assert header in out, header


def test_offload_plan_steps(offload_run):
    plan = offload_run[0]["plan"]
    # the paper's conclusion from measured traffic: the prototype's
    # boundary loses
    assert plan["prototype_offload"] is False
    assert plan["max_batch_unconstrained"] == {"conv": 16}
    assert plan["max_batch_at_deadline"]["conv"] < 16
    assert plan["fidelity_ok"]
    if plan["routes"]["conv"] == "optical-sim":
        assert plan["optical_calls"] == 24
        assert plan["boundary_s_per_call"] < plan["unbatched_boundary_s"]
    else:                      # the plan kept conv on the host
        assert plan["stack_rel_err"] == 0.0


def test_offload_sharded_step(offload_run):
    sh = offload_run[0]["sharded"]
    enob = min(texample.BATCHED_4F.dac.effective_bits,
               texample.BATCHED_4F.adc.effective_bits)
    assert sh["rel_err"] <= texample.enob_error_bound(enob, 16.0)
    assert sh["device_samples"] == {d: (2 * 512 * 512, 2 * 512 * 512)
                                    for d in range(4)}
    spec4 = dataclasses.replace(texample.BATCHED_4F,
                                phase_shift_captures=texample.CONV_CAPTURES)
    assert sh["single_modeled_s"] == spec4.batched_step_cost(
        512 * 512, batch=8, pipeline_depth=2).total_s
    assert sh["sharded_modeled_s"] < sh["single_modeled_s"]


# a last-level cache that budgets the 512x512 fft group into tiles of 4
PINNED_LLC_BYTES = 64 * 2 ** 20


@pytest.mark.parametrize("budget", ["detected", "pinned"])
def test_offload_tiled_step(offload_run, budget, monkeypatch):
    """Step 7 under the budget detected for this host's CPU (its
    last-level cache; a large one leaves the group of 8 frames one tile)
    and under a budget pinned to a 64 MiB cache, which makes the router
    tile the group whatever the host: what the router promises, every
    dispatched tile at most ``tile_k``, the tiles summing to the 8
    frames, the largest ``min(tile_k, 8)``."""
    if budget == "detected":
        t = offload_run[0]["tiled"]
    else:
        from repro_torch.runtime import tiling
        monkeypatch.setattr(tiling, "_llc_bytes", lambda: PINNED_LLC_BYTES)
        imgs, _ = texample.inputs(CPU)
        with redirect_stdout(io.StringIO()):
            t = texample.run_tiled_demo(imgs, device=CPU)
        assert t["tile_k"] < texample.IMAGES
    want = texample.MemoryBudget.detect(CPU)
    assert (t["budget_bytes"], t["budget_source"]) == (want.bytes_limit,
                                                       want.source)
    tiles = t["dispatched_tile_sizes"]
    assert max(tiles) <= t["tile_k"]
    assert sum(k * v for k, v in tiles.items()) == texample.IMAGES == 8
    assert max(tiles) == min(t["tile_k"], texample.IMAGES)
    assert t["bytes_per_frame"] > 0


def test_offload_traced_chaos_and_residency_steps(offload_run):
    r = offload_run[0]
    assert r["traced"]["spans"] > 8 and r["traced"]["drift"]["invocations"] == 1
    chaos = r["chaos"]
    assert chaos["all_retired"] and chaos["faults_total"] > 0
    assert chaos["worst_rel_err"] <= chaos["enob_bound"]
    res = r["residency"]
    assert res["cold_dac_s"] > 0.0 and res["hit_dac_s"] == 0.0
    assert res["hit_rate"] == 0.5 and res["bit_equal"]
    assert math.isfinite(r["trickle"]["scheduler-held"]["modeled_s_per_call"])
