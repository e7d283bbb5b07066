"""The port's tracer, metrics and trace export against the reference's, on
the CPU.

Mirrors ``tests/test_tracing.py``: the span-tree invariants under looped,
batched, pipelined, scheduler-held, sharded and tiled dispatch; exact holds
under a shared ``ManualClock``; histogram, registry and telemetry
mechanics; the drift report; and the Perfetto export, including the 10 %
``reconcile`` gate on a traced 512x512 tiled + sharded flush.  The export
is also held to the reference's: both packages' ``to_trace_events``,
``stage_sums``, ``reconcile`` and ``summarize`` run on the same spans and
must agree exactly, and a flush traced under a ``ManualClock`` in each
package exports the same events.
"""

import dataclasses
import json
import math
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import accelerator as jacc
from repro_torch import runtime as trt
from repro_torch.core import accelerator as tacc
from repro_torch.core import conversion as tconv


def _laned(acc):
    return dataclasses.replace(
        acc.PROTOTYPE_4F, name="laned-4f", interface_latency_s=1.0e-3,
        dac_lanes=48, adc_lanes=48, slm_interface_hz=100e6,
        camera_interface_hz=100e6)


LANED_4F = _laned(tacc)
HI_FI_ADC = tconv.ConverterSpec(name="hifi-adc", kind="adc", bits=12,
                                rate_hz=5.0e8, power_w=0.060, enob=10.5)


def _imgs(n, shape=(32, 32), seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random(shape, dtype=np.float32))
            for _ in range(n)]


def _ex(spec=LANED_4F, **kw):
    return trt.OffloadExecutor(spec, device="cpu", **kw)


def _invocations(spans):
    return [s for s in spans if s.name == "invocation"]


def _assert_tree_invariants(spans, n_calls):
    by_id = {s.span_id: s for s in spans}
    invs = _invocations(spans)
    ids = [cid for s in invs for cid in s.attrs["call_ids"]]
    assert sorted(ids) == list(range(1, n_calls + 1)), ids
    for s in spans:
        assert s.t1 is not None and s.t1 >= s.t0
        if s.parent_id is not None and s.parent_id in by_id:
            assert s.trace_id == by_id[s.parent_id].trace_id
    for inv in invs:
        kids = [s for s in spans if s.parent_id == inv.span_id]
        names = {s.name for s in kids}
        assert "stage" in names and "compute" in names, names
        for k in kids:
            if k.kind == "sync":
                assert k.t0 >= inv.t0 - 1e-9 and k.t1 <= inv.t1 + 1e-9, \
                    (k.name, k.t0, k.t1, inv.t0, inv.t1)
        assert inv.attrs["stage_s"] + inv.attrs["compute_s"] == \
            pytest.approx(inv.attrs["wall_s"], abs=1e-12)
    comps = sorted((s for s in spans
                    if s.name == "compute" and s.lane == "device"),
                   key=lambda s: s.t0)
    for a, b in zip(comps, comps[1:]):
        assert b.t0 >= a.t1 - 1e-12, (a.t1, b.t0)


def _traced_flush(ex, tracer, imgs, batch):
    ex.warm("fft", imgs[0], batch=batch)
    tracer.clear()
    for im in imgs:
        ex.submit("fft", im)
    ex.flush()
    return tracer.spans()


# --- span-tree invariants across dispatch modes ---------------------------------


def test_batched_flush_span_tree():
    tracer = trt.Tracer()
    spans = _traced_flush(_ex(max_batch=8, tracer=tracer), tracer,
                          _imgs(8), 8)
    invs = _invocations(spans)
    assert len(invs) == 1 and invs[0].attrs["batch"] == 8
    assert invs[0].attrs["reason"] == "flush"
    assert len([s for s in spans if s.name == "submit"]) == 8
    _assert_tree_invariants(spans, 8)
    assert invs[0].attrs["modeled_total_s"] > 0.0


def test_looped_flushes_one_tree_per_call():
    tracer = trt.Tracer()
    ex = _ex(max_batch=8, tracer=tracer)
    imgs = _imgs(4)
    ex.warm("fft", imgs[0])
    tracer.clear()
    for im in imgs:
        ex.submit("fft", im)
        ex.flush()
    spans = tracer.spans()
    invs = _invocations(spans)
    assert len(invs) == 4 and all(s.attrs["batch"] == 1 for s in invs)
    _assert_tree_invariants(spans, 4)


def test_pipelined_flush_async_span_tree():
    tracer = trt.Tracer()
    ex = _ex(max_batch=4, pipeline_depth=2, tracer=tracer)
    imgs = _imgs(12)
    ex.warm("fft", imgs[0], batch=4)
    tracer.clear()
    handles = [ex.submit("fft", im) for im in imgs]
    ex.flush_async()
    ex.drain()
    assert all(h.done() for h in handles)
    spans = tracer.spans()
    assert len(_invocations(spans)) == 3
    _assert_tree_invariants(spans, 12)


def test_sharded_dispatch_emits_per_device_children():
    tracer = trt.Tracer()
    spans = _traced_flush(_ex(max_batch=8, n_devices=4,
                              default_backend="sharded", tracer=tracer),
                          tracer, _imgs(8), 8)
    _assert_tree_invariants(spans, 8)
    scatters = [s for s in spans if s.name == "scatter"]
    assert sorted(s.lane for s in scatters) == \
        ["device0", "device1", "device2", "device3"]
    assert sum(s.attrs["frames"] for s in scatters) == 8
    by_id = {s.span_id: s for s in spans}
    for sc in scatters:
        stage = by_id[sc.parent_id]
        assert stage.name == "stage"
        assert by_id[stage.parent_id].name == "invocation"
    rep = trt.drift_report(spans)
    assert set(rep.per_device_s) == {0, 1, 2, 3}
    assert all(v > 0.0 for v in rep.per_device_s.values())


def test_sharded_export_has_one_named_lane_per_device(tmp_path):
    tracer = trt.Tracer()
    spans = _traced_flush(_ex(max_batch=8, n_devices=4,
                              default_backend="sharded", tracer=tracer),
                          tracer, _imgs(8), 8)
    path = tmp_path / "sharded.json"
    trt.write_trace(str(path), spans)
    events = json.loads(path.read_text())["traceEvents"]
    lanes = [e["args"]["name"] for e in events if e["ph"] == "M"]
    assert lanes[:2] == ["sched", "host"]
    assert {f"device{d}" for d in range(4)} <= set(lanes)
    assert len(lanes) == len(set(lanes))


def test_tiled_dispatch_one_invocation_per_tile():
    imgs = _imgs(8, shape=(64, 64))
    budget = trt.MemoryBudget(2 * 2 * 64 * 64 * 4, source="manual",
                              reserve=1.0)
    tracer = trt.Tracer()
    spans = _traced_flush(_ex(max_batch=8, mem_budget=budget, tracer=tracer),
                          tracer, imgs, 8)
    invs = _invocations(spans)
    assert len(invs) > 1, "budget did not split the group"
    assert sorted(s.attrs["tile"] for s in invs) == list(range(len(invs)))
    assert all(s.attrs["tiles"] == len(invs) for s in invs)
    _assert_tree_invariants(spans, 8)


def test_fidelity_shadow_span_recorded():
    tracer = trt.Tracer()
    spec = dataclasses.replace(LANED_4F, adc=HI_FI_ADC)
    spans = _traced_flush(_ex(spec, fidelity=trt.FidelityChecker(),
                              max_batch=4, tracer=tracer),
                          tracer, _imgs(4), 4)
    (inv,) = _invocations(spans)
    shadows = [s for s in spans if s.name == "fidelity-shadow"]
    assert len(shadows) == 1 and shadows[0].parent_id == inv.span_id
    assert inv.attrs["shadow_s"] > 0.0
    _assert_tree_invariants(spans, 4)


def test_warm_does_not_trace():
    tracer = trt.Tracer()
    ex = _ex(max_batch=4, n_devices=2, default_backend="sharded",
             tracer=tracer)
    ex.warm("fft", _imgs(1)[0], batch=4)
    assert tracer.spans() == []


def test_untraced_executor_has_no_tracer_anywhere():
    ex = _ex(max_batch=4)
    assert ex.tracer is None and ex.ctx.tracer is None
    for im in _imgs(4):
        ex.submit("fft", im)
    ex.flush()


# --- scheduler: exact holds and release reasons under a ManualClock -------------


def test_held_span_exact_duration_and_due_reason():
    clk = trt.ManualClock()
    tracer = trt.Tracer(clock=clk)
    ex = _ex(max_batch=8, clock=clk, tracer=tracer)
    sched = trt.OffloadScheduler(ex, deadline_s=0.03, clock=clk)
    imgs = _imgs(2)
    ex.warm("fft", imgs[0], batch=2)
    tracer.clear()
    sched.submit("fft", imgs[0])
    sched.submit("fft", imgs[1])
    clk.advance(0.03)
    sched.poll()
    (rel,) = [s for s in tracer.spans() if s.name == "release"]
    assert rel.attrs["reason"] == "due"
    (held,) = [s for s in tracer.spans() if s.name == "held"]
    assert held.duration_s == pytest.approx(0.03, abs=1e-12)
    assert held.lane == "sched" and held.attrs["reason"] == "due"
    ex.drain()
    (inv,) = _invocations(tracer.spans())
    assert held.parent_id == inv.span_id
    assert inv.attrs["hold_s"] == pytest.approx(0.03, abs=1e-12)
    assert tracer.metrics.counter("release", reason="due").value == 1


def test_release_reason_full_when_group_fills():
    clk = trt.ManualClock()
    tracer = trt.Tracer(clock=clk)
    ex = _ex(max_batch=2, clock=clk, tracer=tracer)
    sched = trt.OffloadScheduler(ex, deadline_s=10.0, clock=clk)
    imgs = _imgs(2)
    ex.warm("fft", imgs[0], batch=2)
    tracer.clear()
    sched.submit("fft", imgs[0])
    clk.advance(0.01)
    sched.submit("fft", imgs[1])
    (rel,) = [s for s in tracer.spans() if s.name == "release"]
    assert rel.attrs["reason"] == "full"
    (held,) = [s for s in tracer.spans() if s.name == "held"]
    assert held.duration_s == pytest.approx(0.01, abs=1e-12)


def test_release_reason_futile_when_arrivals_too_sparse():
    clk = trt.ManualClock()
    tracer = trt.Tracer(clock=clk)
    ex = _ex(max_batch=8, clock=clk, tracer=tracer)
    sched = trt.OffloadScheduler(ex, deadline_s=0.5, clock=clk)
    imgs = _imgs(8)
    ex.warm("fft", imgs[0])
    tracer.clear()
    for im in imgs[:6]:
        clk.advance(5.0)
        sched.submit("fft", im)
        sched.poll()
    reasons = {s.attrs["reason"]
               for s in tracer.spans() if s.name == "release"}
    assert "futile" in reasons, reasons


# --- tracer mechanics ------------------------------------------------------------


def test_ring_buffer_drops_oldest_and_counts():
    tr = trt.Tracer(capacity=3)
    for i in range(5):
        tr.instant(f"e{i}")
    assert tr.dropped == 2
    assert [s.name for s in tr.spans()] == ["e2", "e3", "e4"]
    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0
    with pytest.raises(ValueError):
        trt.Tracer(capacity=0)


def test_lexical_nesting_and_trace_id_inheritance():
    clk = trt.ManualClock()
    tr = trt.Tracer(clock=clk)
    with tr.span("outer") as outer:
        clk.advance(1.0)
        with tr.span("inner", lane="device") as inner:
            clk.advance(0.5)
        assert tr.current() is outer
    assert tr.current() is None
    assert inner.parent_id == outer.span_id
    assert inner.trace_id == outer.trace_id == outer.span_id
    assert inner.duration_s == pytest.approx(0.5)
    assert outer.duration_s == pytest.approx(1.5)
    assert [s.name for s in tr.spans()] == ["inner", "outer"]


def test_end_and_record_clamp_reversed_clock():
    tr = trt.Tracer(clock=trt.ManualClock())
    s = tr.begin("x")
    done = tr.end(s, t1=s.t0 - 5.0)
    assert done.t1 == done.t0 and done.duration_s == 0.0
    tr2 = trt.Tracer()
    r = tr2.record("w", 2.0, 1.0)
    assert r.t0 == 2.0 and r.t1 == 2.0
    assert tr2.find("w") == [r]


# --- histograms and registries ---------------------------------------------------


def test_histogram_empty_single_and_within_one_bin():
    h = trt.Histogram()
    assert math.isnan(h.percentile(50)) and math.isnan(h.mean)
    h.record(3.7e-4)
    for p in (0.0, 50.0, 99.0, 100.0):
        assert h.percentile(p) == pytest.approx(3.7e-4, rel=0, abs=0)
    h2 = trt.Histogram()
    vals = [1e-4 * (1 + 0.01 * i) for i in range(100)]
    for v in vals:
        h2.record(v)
    rel_err = 10 ** (1 / h2.bins_per_decade) - 1
    assert h2.percentile(50) == pytest.approx(sorted(vals)[49], rel=rel_err)
    with pytest.raises(ValueError):
        h2.percentile(101.0)


def test_histogram_merge_associative_exact_and_like_reference():
    rng = np.random.default_rng(7)
    samples = [rng.uniform(1e-6, 1e-2, 50) for _ in range(3)]
    hs = []
    for chunk in samples:
        h = trt.Histogram()
        for v in chunk:
            h.record(float(v))
        hs.append(h)
    ab_c = hs[0].copy()
    ab_c.merge(hs[1])
    ab_c.merge(hs[2])
    bc = hs[1].copy()
    bc.merge(hs[2])
    a_bc = hs[0].copy()
    a_bc.merge(bc)
    assert ab_c.counts == a_bc.counts and ab_c.n == a_bc.n == 150
    assert ab_c.min == a_bc.min and ab_c.max == a_bc.max
    one, ref = trt.Histogram(), jrt.Histogram()
    for chunk in samples:
        for v in chunk:
            one.record(float(v))
            ref.record(float(v))
    assert one.counts == ab_c.counts == ref.counts
    for p in (50.0, 95.0, 99.0):
        assert one.percentile(p) == ref.percentile(p)
    with pytest.raises(ValueError):
        trt.Histogram().merge(trt.Histogram(bins_per_decade=8))
    with pytest.raises(ValueError):
        trt.Histogram(lo=1.0, hi=0.5)


def test_metrics_registry_merge_and_reset():
    a, b = trt.MetricsRegistry(), trt.MetricsRegistry()
    a.counter("release", reason="full").inc(2)
    b.counter("release", reason="full").inc(3)
    b.counter("release", reason="due").inc()
    b.histogram("wall").record(1e-3)
    a.merge(b)
    assert a.counter("release", reason="full").value == 5
    assert a.counter("release", reason="due").value == 1
    assert a.histogram("wall").n == 1
    b.histogram("wall").record(1e-3)
    assert a.histogram("wall").n == 1
    a.reset()
    assert a.counters() == {} and a.histograms() == {}


# --- telemetry: idempotent stop + percentile round trips --------------------------


def test_stop_without_start_and_reset_mid_window():
    t = trt.RuntimeTelemetry()
    assert t.stop() == 0.0
    assert t.stop() == 0.0
    t.start()
    w = t.stop()
    assert w >= 0.0 and t.stop() == pytest.approx(w)
    t2 = trt.RuntimeTelemetry()
    t2.start()
    t2.reset()
    assert t2.stop() == 0.0


def test_telemetry_percentiles_per_category_backend():
    t = trt.RuntimeTelemetry()
    for w in (1e-3, 2e-3, 3e-3):
        t.record("fft", "optical-sim", calls=1, samples_in=64,
                 samples_out=64, wall_s=w)
    t.record("conv", "host", calls=1, samples_in=64, samples_out=64,
             wall_s=5e-3)
    pct = t.percentiles("fft", "optical-sim")
    assert set(pct) == {50.0, 95.0, 99.0}
    assert pct[50.0] == pytest.approx(2e-3, rel=0.2)
    assert pct[50.0] <= pct[95.0] <= pct[99.0]
    assert math.isnan(t.percentiles("fft", "ideal")[50.0])
    assert t.latency_histogram("fft").n == 3


def test_telemetry_percentiles_merge_and_reset_round_trip():
    a, b = trt.RuntimeTelemetry(), trt.RuntimeTelemetry()
    for w in (1e-3, 2e-3):
        a.record("fft", "optical-sim", calls=1, samples_in=4,
                 samples_out=4, wall_s=w)
    for w in (3e-3, 4e-3):
        b.record("fft", "optical-sim", calls=1, samples_in=4,
                 samples_out=4, wall_s=w)
    a.merge(b)
    assert a.latency_histogram("fft", "optical-sim").n == 4
    assert a.percentiles("fft")[99.0] == pytest.approx(4e-3, rel=0.2)
    a.reset()
    assert math.isnan(a.percentiles("fft")[50.0])
    assert b.latency_histogram("fft", "optical-sim").n == 2
    assert "p95" in b.summary()


def test_executor_records_latency_histograms():
    ex = _ex(max_batch=4)
    imgs = _imgs(8)
    ex.warm("fft", imgs[0], batch=4)
    for im in imgs:
        ex.submit("fft", im)
    ex.flush()
    assert ex.telemetry.latency_histogram("fft", "optical-sim").n == 2
    assert all(v > 0.0 for v in ex.telemetry.percentiles("fft").values())


# --- drift report -----------------------------------------------------------------


def _mk_inv(tr, *, modeled=True, stage_s=0.5, compute_s=1.0, hold_s=0.0,
            category="fft", backend="optical-sim"):
    inv = tr.begin("invocation", category=category, backend=backend)
    attrs = dict(wall_s=stage_s + compute_s, stage_s=stage_s,
                 compute_s=compute_s, hold_s=hold_s, shadow_s=0.0)
    if modeled:
        attrs.update(modeled_dac_s=1.0, modeled_interface_s=0.0,
                     modeled_analog_s=0.25, modeled_adc_s=0.25,
                     modeled_host_s=0.0, modeled_hold_s=hold_s,
                     modeled_total_s=1.5 + hold_s)
    inv.annotate(**attrs)
    tr.end(inv)
    return inv


def test_drift_report_ratios_worst_filters_and_unmodeled():
    tr = trt.Tracer(clock=trt.ManualClock())
    _mk_inv(tr)
    rep = trt.drift_report(tr.spans())
    assert rep.invocations == 1 and rep.unmodeled == 0
    assert rep.stages["stage"].drift == pytest.approx(0.5)
    assert rep.stages["compute"].drift == pytest.approx(2.0)
    assert rep.stages["total"].drift == pytest.approx(1.0)
    assert rep.worst.stage in ("stage", "compute")
    assert math.isnan(rep.stages["hold"].drift)
    assert "drift" in rep.table()
    _mk_inv(tr, category="conv", backend="host", modeled=False)
    rep2 = trt.drift_report(tr.spans())
    assert rep2.invocations == 1 and rep2.unmodeled == 1
    only_conv = trt.drift_report(tr.spans(), category="conv")
    assert only_conv.invocations == 0 and only_conv.unmodeled == 1


def test_drift_inf_and_nan_serialization():
    tr = trt.Tracer(clock=trt.ManualClock())
    inv = tr.begin("invocation", category="fft", backend="optical-sim")
    inv.annotate(wall_s=1.0, stage_s=1.0, compute_s=0.0, hold_s=0.0,
                 shadow_s=0.0, modeled_dac_s=0.0, modeled_interface_s=0.0,
                 modeled_analog_s=0.0, modeled_adc_s=0.0, modeled_host_s=0.0,
                 modeled_hold_s=0.0, modeled_total_s=1.0)
    tr.end(inv)
    rep = trt.drift_report(tr.spans())
    assert math.isinf(rep.stages["stage"].drift)
    assert math.isnan(rep.stages["compute"].drift)
    j = rep.to_json()
    assert j["stages"]["stage"]["drift"] == "inf"
    assert j["stages"]["compute"]["drift"] is None
    assert j["worst_stage"] == "stage"


def test_router_replan_snapshots_drift_only_when_traced():
    tracer = trt.Tracer()
    ex = _ex(max_batch=4, tracer=tracer)
    router = trt.PlanRouter(ex)
    imgs = _imgs(4)
    ex.warm("fft", imgs[0], batch=4)
    ex.telemetry.start()
    for h in [ex.submit("fft", im) for im in imgs]:
        h.get()
    ex.telemetry.stop()
    router.replan()
    assert router.drift is not None and router.drift.invocations >= 1
    assert "drift" in router.summary()
    ex2 = _ex(max_batch=4)
    router2 = trt.PlanRouter(ex2)
    ex2.telemetry.start()
    for h in [router2.submit("fft", im) for im in imgs]:
        h.get()
    ex2.telemetry.stop()
    router2.replan()
    assert router2.drift is None


# --- Perfetto export --------------------------------------------------------------


def test_trace_events_well_formed():
    clk = trt.ManualClock()
    tracer = trt.Tracer(clock=clk)
    spans = _traced_flush(_ex(max_batch=4, clock=clk, tracer=tracer),
                          tracer, _imgs(4), 4)
    events = trt.to_trace_events(spans)
    assert {e["ph"] for e in events} == {"M", "X", "b", "e", "i"}
    metas = [e for e in events if e["ph"] == "M"]
    assert [m["args"]["name"] for m in metas][:2] == ["sched", "host"]
    assert all(m["name"] == "thread_name" for m in metas)
    begins = {(e["cat"], e["id"]) for e in events if e["ph"] == "b"}
    ends = {(e["cat"], e["id"]) for e in events if e["ph"] == "e"}
    assert begins == ends and begins
    for e in events:
        if e["ph"] == "X":
            assert e["dur"] >= 0.0
        if e["ph"] != "M":
            assert e["ts"] >= 0.0
    inv_ev = [e for e in events
              if e["ph"] == "b" and e["name"] == "invocation"]
    assert inv_ev and "span_id" in inv_ev[0]["args"]


def test_to_trace_events_empty_and_summarize_empty():
    assert trt.to_trace_events([]) == []
    assert "no spans" in trt.summarize([])


def test_write_trace_round_trips(tmp_path):
    tr = trt.Tracer(clock=trt.ManualClock())
    with tr.span("stage"):
        pass
    path = tmp_path / "trace.json"
    payload = trt.write_trace(str(path), tr.spans())
    on_disk = json.loads(path.read_text())
    assert on_disk == payload
    assert on_disk["traceEvents"] and on_disk["displayTimeUnit"] == "ms"


def _sharded_spans(rt, spec, frames, **kw):
    """A traced sharded flush under a ManualClock in either package."""
    clk = rt.ManualClock()
    tracer = rt.Tracer(clock=clk)
    ex = rt.OffloadExecutor(spec, max_batch=8, n_devices=4,
                            default_backend="sharded", clock=clk,
                            tracer=tracer, **kw)
    for x in frames:
        ex.submit("fft", x)
    ex.flush()
    return tracer.spans()


def test_export_equals_reference_on_the_same_spans(tmp_path):
    """Both packages' exporters on the port's spans of a traced sharded
    flush: identical events, JSON, stage sums, reconcile and summary."""
    tracer = trt.Tracer()
    spans = _traced_flush(_ex(max_batch=8, n_devices=4,
                              default_backend="sharded", tracer=tracer,
                              fidelity=trt.FidelityChecker()),
                          tracer, _imgs(8), 8)
    assert trt.to_trace_events(spans) == jrt.to_trace_events(spans)
    assert trt.stage_sums(spans) == jrt.stage_sums(spans)
    assert trt.reconcile(spans, 0.5) == jrt.reconcile(spans, 0.5)
    assert trt.summarize(spans) == jrt.summarize(spans)
    a, b = tmp_path / "port.json", tmp_path / "ref.json"
    trt.write_trace(str(a), spans)
    jrt.write_trace(str(b), spans)
    assert a.read_text() == b.read_text()


def test_manual_clock_flush_exports_like_the_reference(monkeypatch):
    """Under a ManualClock every timestamp is the manual clock's, so the
    same flush traced in each package exports the same event stream:
    names, lanes, phases, timestamps and the pure-Python attrs.  Both
    packages' straggler watchdogs are held off: they score each shard by
    its host wall (``perf_counter``), not the ManualClock, so on a loaded
    test host one package alone could quarantine a device and move its
    event stream."""
    for cls in (jrt.DispatchWatchdog, trt.DispatchWatchdog):
        monkeypatch.setattr(cls, "observe",
                            lambda self, key, dt_s, base_s=None: False)
    rng = np.random.default_rng(3)
    frames = [rng.random((16, 12), dtype=np.float32) for _ in range(8)]
    tspans = _sharded_spans(trt, LANED_4F,
                            [torch.from_numpy(x) for x in frames],
                            device="cpu")
    jspans = _sharded_spans(jrt, _laned(jacc),
                            [jnp.asarray(x) for x in frames])
    keep = ("frames", "device", "batch", "category", "backend", "call_ids",
            "reason", "tile", "tiles", "modeled_total_s", "span_id",
            "parent_id")

    def strip(events):
        return [{k: (v if k != "args" else
                     {a: x for a, x in v.items() if a in keep})
                 for k, v in e.items()} for e in events]

    assert strip(trt.to_trace_events(tspans)) == \
        strip(jrt.to_trace_events(jspans))
    assert trt.summarize(tspans).splitlines()[:3] == \
        jrt.summarize(jspans).splitlines()[:3]


# --- acceptance: traced 512x512 tiled + sharded flush -----------------------------


def test_traced_tiled_sharded_flush_reconciles(tmp_path):
    """A traced 512x512 tiled+sharded flush exports valid Perfetto JSON
    whose per-stage charged sums reconcile with the measured flush wall to
    within 10 % and join against the modeled decomposition per stage."""
    imgs = _imgs(8, shape=(512, 512))
    budget = trt.MemoryBudget(2 * 4 * 512 * 512 * 4, source="manual",
                              reserve=1.0)
    tracer = trt.Tracer()
    ex = _ex(max_batch=8, n_devices=2, default_backend="sharded",
             mem_budget=budget, tracer=tracer)
    ex.warm("fft", imgs[0], batch=8)
    tracer.clear()
    for im in imgs:
        ex.submit("fft", im)
    t0 = time.perf_counter()
    ex.flush()
    wall = time.perf_counter() - t0
    spans = tracer.spans()
    invs = _invocations(spans)
    assert len(invs) > 1, "budget did not tile the group"
    assert all(s.attrs["tiles"] == len(invs) for s in invs)
    _assert_tree_invariants(spans, 8)
    assert any(s.name == "scatter" for s in spans)
    rec = trt.reconcile(spans, wall)
    assert rec["coverage"] == pytest.approx(1.0, abs=0.10), rec
    sums = trt.stage_sums(spans)
    assert sums["stage"] + sums["compute"] == pytest.approx(sums["wall"])
    rep = trt.drift_report(spans)
    assert rep.invocations == len(invs) and rep.unmodeled == 0
    for st in ("stage", "compute", "total"):
        assert rep.stages[st].modeled_s > 0.0
    for st in ("stage", "total"):
        assert rep.stages[st].measured_s > 0.0
        assert rep.stages[st].drift > 0.0
    # on the CPU a dispatch returns with its results computed, so the
    # executor charges the whole wall to staging (the reference's async
    # dispatch leaves a compute share; on the card, CUDA events do)
    assert rep.stages["compute"].measured_s == 0.0
    payload = trt.write_trace(str(tmp_path / "trace.json"), spans)
    assert {e["ph"] for e in payload["traceEvents"]} >= {"M", "X", "b", "e"}


def test_traced_results_match_untraced():
    imgs = _imgs(6)
    for kw in ({}, {"n_devices": 3, "default_backend": "sharded"}):
        ex0 = _ex(max_batch=6, **kw)
        h0 = [ex0.submit("fft", im) for im in imgs]
        ex0.flush()
        ex1 = _ex(max_batch=6, tracer=trt.Tracer(), **kw)
        h1 = [ex1.submit("fft", im) for im in imgs]
        ex1.flush()
        for a, b in zip(h0, h1):
            torch.testing.assert_close(a.value, b.value, rtol=0, atol=0)
            assert a.cost.total_s == b.cost.total_s
