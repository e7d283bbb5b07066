"""The runtime benchmark's twin against the reference's, on the CPU.

Both modules run at small sizes, as the reference's CI smoke runs its own
(``sweep(batch_sizes=(1, 4), shape=(64, 64), calls=8)``), on the same
frames: the reference's ``_images`` is patched (here only) to the port's
seeded numpy frames.  What is deterministic is held equal:

* the cost-model prices (``boundary_s_per_call``, ``modeled_s_per_call``)
  and the invocation counts, bit for bit;
* the trickle column under its ``ManualClock``, whole;
* the chaos rows' fault counts, retirements, ENOB verdicts and recovery
  counts (a drift recovery's latency is a host wall in both packages);
* the sharded column's modeled walls and device counts;
* the large-frame column's chosen and dispatched tiles under one manual
  ``MemoryBudget``;
* ``drift_gate``'s verdict and message, the CSV rows of one payload.

Walls are measured, never compared: CPU walls under parallel test workers
say nothing.  ``residency_comparison`` draws its fresh and drifted frames
inside itself (``jax.random`` in the reference), so it is held to its
invariants and counts.
"""

import builtins
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import runtime_bench as jbench
from repro.runtime import DispatchWatchdog as JWatchdog
from repro.runtime import MemoryBudget as JBudget
from repro_torch.casestudy import runtime_bench as tbench
from repro_torch.runtime import DispatchWatchdog as TWatchdog
from repro_torch.runtime import MemoryBudget as TBudget

CPU = "cpu"
REFERENCE_FILES = (jbench.BENCH_JSON, jbench.BENCH_HISTORY)


@pytest.fixture
def same_frames(monkeypatch):
    """The reference's bench draws the port's frames."""
    monkeypatch.setattr(
        jbench, "_images",
        lambda n=jbench.CALLS, shape=jbench.SHAPE:
            [jnp.asarray(a) for a in tbench.frames(n, shape)])


@pytest.fixture
def no_wall_stragglers(monkeypatch):
    """Columns timed on the host clock: both packages' straggler
    watchdogs score no dispatch as a straggler.  Their verdict is a wall
    against a trailing median, so under a loaded test host either package
    could quarantine a device or a category mid-column and move its
    modeled prices; the columns on a ``ManualClock`` (trickle, chaos)
    keep their watchdogs."""
    for cls in (JWatchdog, TWatchdog):
        monkeypatch.setattr(cls, "observe",
                            lambda self, key, dt_s, base_s=None: False)


def _same(ref: dict, port: dict, keys) -> None:
    for k in keys:
        assert port[k] == ref[k], (k, ref[k], port[k])


def test_constants_are_the_reference_s():
    for name in ("SHAPE", "CALLS", "DRIFT_BAND", "DRIFT_HISTORY_FACTOR",
                 "LARGE_SHAPE", "LARGE_CALLS", "CHAOS_RATES", "CHAOS_CALLS",
                 "CHAOS_SHAPE", "CHAOS_MAX_BATCH", "CHAOS_SEED",
                 "TRICKLE_RATE_HZ", "TRICKLE_DEADLINE_S", "TRICKLE_ARRIVALS",
                 "TRICKLE_MAX_BATCH", "TRICKLE_SEED"):
        assert getattr(tbench, name) == getattr(jbench, name), name
    assert {tbench.SNAPSHOT, tbench.HISTORY}.isdisjoint(REFERENCE_FILES)


def test_frames_are_seeded_and_on_the_asked_device():
    a = tbench.frames(3, (8, 8))
    b = tbench.frames(3, (8, 8))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert a[0].dtype == np.float32 and 0.0 <= a[0].min() < a[0].max() < 1.0
    assert not np.array_equal(a[0], a[1])
    imgs = tbench._images(3, (8, 8), CPU)
    assert all(t.device.type == "cpu" for t in imgs)
    assert len({t.data_ptr() for t in imgs}) == 3     # separate tensors
    assert np.array_equal(imgs[2].numpy(), a[2])


@pytest.mark.parametrize("batch_sizes,shape,calls", [
    ((1, 4), (64, 64), 8),          # the reference CI's smoke
    ((1, 2, 3), (16, 24), 7),       # a ragged tail group
])
def test_sweep_matches_reference(same_frames, no_wall_stragglers,
                                 batch_sizes, shape, calls):
    ref = jbench.sweep(batch_sizes=batch_sizes, shape=shape, calls=calls)
    port = tbench.sweep(batch_sizes=batch_sizes, shape=shape, calls=calls,
                        device=CPU)
    assert [r.keys() for r in port] == [r.keys() for r in ref]
    for r, p in zip(ref, port):
        _same(r, p, ("max_batch", "boundary_s_per_call",
                     "modeled_s_per_call", "invocations"))
        assert p["wall_s_per_call"] > 0.0
    # the amortization the paper's §6 rests on, in the cost model
    assert port[-1]["boundary_s_per_call"] < port[0]["boundary_s_per_call"]


def test_pipeline_comparison_has_the_reference_s_columns(same_frames, no_wall_stragglers):
    ref = jbench.pipeline_comparison(shape=(32, 32), calls=4)
    port = tbench.pipeline_comparison(shape=(32, 32), calls=4, device=CPU)
    assert port.keys() == ref.keys()
    assert all(v > 0.0 for v in port.values())


def test_sharded_matches_reference(same_frames, no_wall_stragglers):
    """At K=16, 128x128: the reference CI's call."""
    kw = dict(device_counts=(1, 4))
    ref = jbench.sharded_comparison(**kw)
    port = tbench.sharded_comparison(device=CPU, **kw)
    for r, p in zip(ref, port):
        assert p.keys() == r.keys()
        _same(r, p, ("n_devices", "modeled_s_per_call", "boundary_s_per_call",
                     "modeled_speedup", "per_engine_modeled_s_per_call",
                     "resident_hit_rate", "devices_present", "devices_used"))
        assert p["trace"]["stages"].keys() == r["trace"]["stages"].keys()
        for stage, row in p["trace"]["stages"].items():
            assert row["modeled_s"] == r["trace"]["stages"][stage][
                "modeled_s"], stage
    single, quad = port
    # the reference CI's sharded assert: on the deterministic cost model
    assert quad["modeled_s_per_call"] <= single["modeled_s_per_call"]


def test_trickle_matches_reference_under_its_manual_clock(same_frames):
    ref = jbench.trickle_comparison()
    port = tbench.trickle_comparison(device=CPU)
    assert port == ref
    assert port["held_occupancy"] > port["drain_occupancy"]
    assert (port["held_samples_per_crossing"]
            > port["drain_samples_per_crossing"])


@pytest.mark.parametrize("budget_bytes,tile_k", [(200_000, 1),
                                                 (600_000, 2),
                                                 (0, 8)])
def test_large_frame_tiles_match_reference(same_frames, no_wall_stragglers,
                                           monkeypatch, budget_bytes,
                                           tile_k):
    """Both packages under the same manual budget: the same tile chosen,
    the same tiles dispatched, the same modeled walls."""
    for cls in (JBudget, TBudget):
        monkeypatch.setattr(cls, "detect", classmethod(
            lambda c, *a, **k: c(budget_bytes, source="manual",
                                 reserve=0.5)))
    ref = jbench.large_frame_comparison(shape=(64, 64), calls=8)
    port = tbench.large_frame_comparison(shape=(64, 64), calls=8, device=CPU)
    assert port.keys() == ref.keys()
    _same(ref, port, ("budget_bytes", "budget_source", "budget_reserve",
                      "chosen_tile_k", "modeled_bytes_per_frame",
                      "dispatched_tile_sizes", "measured_bytes_per_frame",
                      "tile_matches_dispatch")
          + tuple(f"{r}_{c}" for r in ("looped", "monolithic", "tiled")
                  for c in ("modeled_s_per_call", "invocations")))
    assert port["chosen_tile_k"] == tile_k
    assert port["tile_matches_dispatch"]


def test_chaos_matches_reference(same_frames):
    ref = jbench.chaos_comparison()
    port = tbench.chaos_comparison(device=CPU)
    _same(ref, port, ("shape", "calls", "max_batch", "seed", "enob_bound"))
    for r, p in zip(ref["rows"], port["rows"], strict=True):
        assert p.keys() == r.keys()
        _same(r, p, ("fault_rate", "calls", "retired", "all_retired",
                     "within_bound", "faults", "faults_total",
                     "quarantine_events"))
        assert (p["recovery"] or {}).get("n") == (r["recovery"] or {}).get("n")
        # the reference CI's chaos asserts
        assert p["all_retired"] and p["within_bound"]
    assert any(r["faults_total"] > 0 for r in port["rows"]
               if r["fault_rate"] > 0)


def test_chaos_overhead_has_the_reference_s_columns(same_frames, no_wall_stragglers):
    ref = jbench.chaos_overhead(shape=(32, 32), calls=4, reps=2)
    port = tbench.chaos_overhead(shape=(32, 32), calls=4, reps=2, device=CPU)
    assert port.keys() == ref.keys()
    assert port["plain_wall_s_per_call"] > 0.0
    assert port["chaos_wall_s_per_call"] > 0.0


def test_traced_matches_reference(same_frames, no_wall_stragglers, tmp_path):
    ref = jbench.traced_comparison(shape=(32, 32), calls=8)
    trace = tmp_path / "trace.json"
    port = tbench.traced_comparison(shape=(32, 32), calls=8,
                                    trace_path=str(trace), device=CPU)
    assert port.keys() - {"trace_path"} == ref.keys()
    _same(ref, port, ("shape", "calls", "spans"))
    assert port["reconcile"].keys() == ref["reconcile"].keys()
    assert port["drift"]["invocations"] == ref["drift"]["invocations"]
    for stage, row in port["drift"]["stages"].items():
        assert row["modeled_s"] == ref["drift"]["stages"][stage]["modeled_s"]
    events = json.loads(trace.read_text())["traceEvents"]
    assert len(events) >= port["spans"]


def test_residency_invariants_and_counts(same_frames, no_wall_stragglers):
    """At the reference's sizes (the CI smoke's call)."""
    ref = jbench.residency_comparison()
    port = tbench.residency_comparison(device=CPU)
    assert port.keys() == ref.keys()
    _same(ref, port, ("calls", "shape", "modeled_hit_dac_s",
                      "modeled_restage_dac_s", "hit_rate",
                      "delta_frames_per_flush", "resident_bytes"))
    # the reference CI's residency asserts, walls aside
    assert port["modeled_hit_dac_s"] == 0.0
    assert 0.0 < port["modeled_delta_dac_s"] < port["modeled_restage_dac_s"]
    assert port["hit_rate"] > 0.5
    assert 0.0 < port["delta_flip_fraction"] < 0.35
    assert port["delta_rate"] > 0.0
    assert port["bit_equal_to_plain"] and port["delta_bit_equal_to_plain"]


def test_roundtrip_decisions_match_execution(same_frames, no_wall_stragglers):
    ref = jbench.roundtrip()
    port = tbench.roundtrip(device=CPU)
    assert port.keys() == ref.keys()
    assert port["decisions_match_execution"]
    assert port["adaptive_max_batch"].keys() == ref["adaptive_max_batch"].keys()


# --- drift_gate on synthetic drift dicts and histories -------------------------

def _drift(d):
    return {"stages": {"stage": {"modeled_s": 1.0, "measured_s": 0.5,
                                 "drift": d}}}


def _history(*ds):
    return [{"traced": {"drift": _drift(d)}} for d in ds]


@pytest.mark.parametrize("drift,history", [
    (_drift(0.25), None),
    (_drift(0.004), None),                       # under the band
    (_drift(1.5), None),                         # over it
    (_drift(0.005), None),                       # the edges are in
    (_drift(1.0), None),
    (_drift(None), None),                        # unmeasurable
    (_drift("inf"), None),
    ({"stages": {}}, None),
    (_drift(0.25), _history(0.2, 0.3)),          # < 3 priors: band only
    (_drift(0.25), _history(0.2, 0.3, 0.1)),     # within 4x of the median
    (_drift(0.9), _history(0.1, 0.1, 0.2)),      # past 4x of it
    (_drift(0.01), _history(0.2, 0.3, 0.25, 0.4)),
    (_drift(0.25), _history(0.2, "inf", None) + [{}, {"traced": None},
                                                 {"traced": {"drift": {}}}]),
])
def test_drift_gate_matches_reference(drift, history):
    assert tbench.drift_gate(drift, history) == jbench.drift_gate(drift,
                                                                  history)


# --- records -------------------------------------------------------------------

@pytest.fixture
def no_reference_files(monkeypatch):
    """Fails the test on any open of the reference's record files."""
    real_open = builtins.open

    def guarded(file, *a, **k):
        if isinstance(file, (str, os.PathLike)):
            assert os.path.basename(os.fspath(file)) not in REFERENCE_FILES, \
                file
        return real_open(file, *a, **k)
    monkeypatch.setattr(builtins, "open", guarded)


def test_history_round_trips(tmp_path, no_reference_files):
    path = str(tmp_path / "h" / tbench.HISTORY)
    assert tbench.load_history(path) == []
    recs = [tbench.append_history({"traced": {"drift": _drift(d)}}, path)
            for d in (0.1, 0.2)]
    with open(path, "a") as f:
        f.write("\nnot json\n")
    assert tbench.load_history(path) == recs
    assert all("ts" in r for r in recs)


def _column_stubs(monkeypatch, module, **kw):
    """Every column of ``module``'s payload replaced by a stub."""
    for name in ("sweep", "pipeline_comparison", "sharded_comparison",
                 "trickle_comparison", "large_frame_comparison",
                 "traced_comparison", "chaos_comparison", "chaos_overhead",
                 "residency_comparison"):
        monkeypatch.setattr(module, name,
                            lambda *a, _n=name, **k: {"column": _n})
    monkeypatch.setattr(module, "roundtrip", lambda **k: {
        "plan_speedup": 1.0, "executed_on": {}, "planned_offload": {}})


def test_payload_has_the_reference_s_keys(monkeypatch):
    _column_stubs(monkeypatch, jbench)
    _column_stubs(monkeypatch, tbench)
    ref = jbench.bench_payload()
    port = tbench.bench_payload(CPU)
    assert port.keys() == ref.keys() | {"card"}
    assert port["card"] == "cpu"
    assert {k: v for k, v in port.items() if k != "card"} == ref


def test_write_json_writes_only_under_out(tmp_path, monkeypatch,
                                          no_reference_files):
    _column_stubs(monkeypatch, tbench)
    out = tmp_path / "bench"
    payload = tbench.write_json(CPU, str(out))
    assert sorted(os.listdir(out)) == sorted([tbench.SNAPSHOT,
                                              tbench.HISTORY])
    assert json.loads((out / tbench.SNAPSHOT).read_text()) == payload
    (hist,) = tbench.load_history(str(out / tbench.HISTORY))
    assert {k: v for k, v in hist.items() if k != "ts"} == payload


def _small_payload(monkeypatch):
    """A real payload of the port at small sizes."""
    small = {
        "sweep": dict(batch_sizes=(1, 4), shape=(32, 32), calls=4),
        "pipeline_comparison": dict(shape=(32, 32), calls=2),
        "sharded_comparison": dict(shape=(32, 32), calls=4,
                                   device_counts=(1, 2)),
        "trickle_comparison": dict(arrivals=8),
        "large_frame_comparison": dict(shape=(32, 32), calls=4),
        "traced_comparison": dict(shape=(32, 32), calls=4),
        "chaos_comparison": dict(shape=(16, 16), calls=8),
        "chaos_overhead": dict(shape=(32, 32), calls=4, reps=2),
        "residency_comparison": dict(shape=(32, 32), calls=8, reps=2),
    }
    for name, kw in small.items():
        fn = getattr(tbench, name)
        monkeypatch.setattr(tbench, name,
                            lambda *a, _f=fn, _kw=kw, **k: _f(**_kw, **k))
    return tbench.bench_payload(CPU)


def test_rows_match_the_reference_s_on_one_payload(monkeypatch):
    payload = _small_payload(monkeypatch)
    rows = tbench.run(payload)
    assert rows == jbench.run(payload)
    assert len(rows) == 2 + 1 + 2 + 1 + 1 + 1 + 3 + 1 + 1 + 1


def test_main_writes_rows_and_the_gate(tmp_path, monkeypatch, capsys,
                                       no_reference_files):
    payload = _small_payload(monkeypatch)
    monkeypatch.setattr(tbench, "bench_payload", lambda device: payload)
    out = tmp_path / "b"
    for _ in range(2):
        assert tbench.main(["--device", "cpu", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[:2] == ["section,name,us_per_call,derived", "device,cpu,,"]
    assert lines[2:2 + len(tbench.run(payload))] == tbench.run(payload)
    assert lines[-1].startswith("drift_gate,")
    assert len(tbench.load_history(str(out / tbench.HISTORY))) == 2


def test_main_refuses_without_a_card(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert tbench.main([]) == 2
    assert "no CUDA card" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


def test_new_modules_import_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch.casestudy.runtime_bench\n"
            "import repro_torch.casestudy.run\n"
            "import repro_torch.examples.quickstart\n"
            "import repro_torch.examples.optical_offload\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.') or m == 'benchmarks' or "
            "m.startswith('benchmarks.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
