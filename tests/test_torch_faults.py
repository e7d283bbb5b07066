"""The port's fault injection and handling against the reference's, on the
CPU.

Mirrors ``tests/test_faults.py``.  The invariant is the reference's:
faulted execution == fault-free execution == looped host baseline, every
frame retiring, with faults changing *when and where* a frame executes,
never *what* it returns.  Both packages draw their schedules and retry
jitter from ``random.Random(seed)``, so on top of the reference's own
checks (run on the port) the same seeded schedule must hand out the same
faults in both packages, fault by fault, and the same run under a
``ManualClock`` must retry, fall back, quarantine and recover identically:
same serving backends, fault counts, quarantine events and manual-clock
time.  Values: bit-equal inside the port where the reference demands it;
against the reference, the cross-package bounds of
``test_torch_runtime.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro_torch import runtime as trt
from repro_torch.distributed.straggler import TrailingMedianDeadline
from repro_torch.runtime.faults import FAULT_KINDS

RTOL = 1e-5
ATOL = 1e-6


def _np_images(n, shape=(32, 32), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.rand(*shape).astype(np.float32) for _ in range(n)]


def _images(n, shape=(32, 32), seed=0):
    return [torch.from_numpy(x) for x in _np_images(n, shape, seed)]


def _ex(rt, *a, **kw):
    if rt is trt:
        kw.setdefault("device", "cpu")
    return rt.OffloadExecutor(*a, **kw)


def _conv(rt, imgs):
    return imgs if rt is trt else [jnp.asarray(x.numpy()) for x in imgs]


def _run_all(ex, imgs, category="fft"):
    with ex:
        handles = [ex.submit(category, im) for im in imgs]
    return handles


def _values(handles):
    return [np.asarray(h.value) for h in handles]


def _optical_reference(imgs, **kw):
    ex = _ex(trt, trt.BATCHED_4F, default_backend="optical-sim",
             clock=trt.ManualClock(), **kw)
    return _values(_run_all(ex, imgs))


def _host_reference(imgs):
    ex = _ex(trt, trt.BATCHED_4F, default_backend="host", max_batch=1)
    return _values(_run_all(ex, imgs))


def _fault_tuple(f):
    return None if f is None else (f.kind, f.delay_s, f.gain, f.device)


def _ledger(ex):
    """What a fault run did, comparable across the packages."""
    return ({k: dict(v) for k, v in ex.telemetry.fault_counts.items()},
            [(e.key, e.reason, e.t, e.until, e.level)
             for e in ex.quarantine.events], ex.now())


def _both(run):
    """``run(rt)`` in the reference and in the port."""
    return run(jrt), run(trt)


# -- the schedule: deterministic injection --------------------------------


@pytest.mark.parametrize("rate,seed", [(0.4, 11), (0.3, 0), (0.1, 2),
                                       (1.0, 7)])
def test_fault_schedule_draws_the_reference_sequence(rate, seed):
    j = jrt.FaultSchedule(rate, seed=seed)
    t = trt.FaultSchedule(rate, seed=seed)
    got = [_fault_tuple(t.draw()) for _ in range(200)]
    assert got == [_fault_tuple(j.draw()) for _ in range(200)]
    assert t.injected == j.injected and t.index == j.index == 200
    kinds = {f[0] for f in got if f is not None}
    assert kinds == set(FAULT_KINDS) if rate >= 0.3 else kinds


def test_fault_schedule_is_deterministic_and_fresh_rewinds():
    sched = trt.FaultSchedule(0.4, seed=11)
    first = [sched.draw() for _ in range(64)]
    replay = [sched.fresh().draw() for _ in range(1)]
    again = sched.fresh()
    assert [again.draw() for _ in range(64)] == first
    assert replay[0] == first[0]
    assert any(f is not None for f in first)
    other = [trt.FaultSchedule(0.4, seed=12).draw() for _ in range(64)]
    assert other != first


def test_fault_schedule_script_pins_indices_without_shifting_stream():
    seqs = []
    for rt in (jrt, trt):
        a = rt.FaultSchedule(0.5, seed=3, script={3: rt.Fault("error")})
        b = rt.FaultSchedule(0.5, seed=3)
        seq = []
        for i in range(16):
            fa, fb = a.draw(), b.draw()
            if i == 3:
                assert fa == rt.Fault("error")
            else:
                assert fa == fb
            seq.append(_fault_tuple(fa))
        seqs.append(seq)
        assert rt.FaultSchedule(rate=0.0).draw() is None
    assert seqs[0] == seqs[1]


def test_fault_kind_validation():
    with pytest.raises(ValueError):
        trt.Fault("meteor-strike")
    with pytest.raises(ValueError):
        trt.FaultSchedule(rate=1.5)
    with pytest.raises(ValueError):
        trt.FaultSchedule(0.5, kinds=("error", "flood"))


# -- the chaos wrapper -----------------------------------------------------


def test_chaos_backend_transparent_at_rate_zero():
    imgs = _images(6)
    name = trt.register_chaos("optical-sim", name="chaos-t0", rate=0.0)
    ex = _ex(trt, trt.BATCHED_4F, default_backend=name, max_batch=3,
             clock=trt.ManualClock())
    got = _values(_run_all(ex, imgs))
    for g, r in zip(got, _optical_reference(imgs, max_batch=3)):
        np.testing.assert_array_equal(g, r)
    assert ex.telemetry.faults_total() == 0
    assert not ex.quarantine.events


def test_transient_error_is_retried_on_same_backend():
    imgs = _images(4)

    def run(rt):
        name = rt.register_chaos("optical-sim", name="chaos-err",
                                 script={0: rt.Fault("error")})
        clk = rt.ManualClock()
        tr = rt.Tracer(clock=clk)
        ex = _ex(rt, rt.BATCHED_4F, default_backend=name, max_batch=4,
                 clock=clk, tracer=tr)
        handles = _run_all(ex, _conv(rt, imgs))
        assert handles[0].backend == "chaos-err"
        assert ex.telemetry.fault_counts["fft"]["error"] == 1
        assert {"fault", "retry"} <= {s.name for s in tr.spans()}
        assert tr.metrics.counter("retries", category="fft",
                                  backend="chaos-err").value == 1
        assert clk() > 0.0   # the backoff elapsed on the injected clock
        return _values(handles), _ledger(ex)

    (jv, jl), (tv, tl) = _both(run)
    assert tl == jl      # the same seeded jitter: the same clock after
    for t, r in zip(tv, _optical_reference(imgs, max_batch=4)):
        np.testing.assert_array_equal(t, r)


def test_retry_exhaustion_degrades_to_host_in_submit_order():
    imgs = _images(5)

    def run(rt):
        name = rt.register_chaos("optical-sim", name="chaos-dead",
                                 script={i: rt.Fault("error")
                                         for i in range(3)})
        clk = rt.ManualClock()
        tr = rt.Tracer(clock=clk)
        ex = _ex(rt, rt.BATCHED_4F, default_backend=name, max_batch=8,
                 clock=clk, tracer=tr)
        handles = _run_all(ex, _conv(rt, imgs))
        assert all(h.backend == "host" for h in handles)
        assert ex.telemetry.recovery_stats("fft")["n"] == 1
        assert ex.quarantine.is_quarantined(("category", "fft"), ex.now())
        assert {"fault", "retry", "fallback", "quarantine"} <= \
            {s.name for s in tr.spans()}
        return _values(handles), _ledger(ex)

    (jv, jl), (tv, tl) = _both(run)
    assert tl == jl
    assert tl[0]["fft"]["error"] == 3 and tl[0]["fft"]["fallback"] == 1
    for t, r in zip(tv, _host_reference(imgs)):
        np.testing.assert_array_equal(t, r)   # digital fallback: bit-equal
    for t, j in zip(tv, jv):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5 * j.max())


def test_quarantine_reroutes_then_readmits_after_probation():
    imgs = _images(12)
    name = trt.register_chaos("optical-sim", name="chaos-q",
                              script={i: trt.Fault("error")
                                      for i in range(3)})
    clk = trt.ManualClock()
    ex = _ex(trt, trt.BATCHED_4F, default_backend=name, max_batch=4,
             clock=clk)
    first = [ex.submit("fft", im) for im in imgs[:4]]
    ex.flush()
    assert all(h.backend == "host" for h in first)
    second = [ex.submit("fft", im) for im in imgs[4:8]]
    ex.flush()
    assert all(h.backend == "host" for h in second)
    assert ex.telemetry.fault_counts["fft"]["reroute"] == 1
    assert ex._backend(name).schedule.index == 3
    clk.advance(ex.retry.quarantine_s + ex.retry.probation_s + 1e-3)
    assert not ex.quarantine.is_quarantined(("category", "fft"), ex.now())
    third = [ex.submit("fft", im) for im in imgs[8:]]
    ex.flush()
    assert all(h.backend == name for h in third)
    for h, r in zip(_values(third),
                    _optical_reference(imgs[8:], max_batch=4)):
        np.testing.assert_array_equal(h, r)


def test_straggler_detected_but_not_retried():
    imgs = _images(8)

    def run(rt):
        name = rt.register_chaos("optical-sim", name="chaos-slow",
                                 script={1: rt.Fault("straggle",
                                                     delay_s=2.0)})
        clk = rt.ManualClock()
        ex = _ex(rt, rt.BATCHED_4F, default_backend=name, max_batch=4,
                 clock=clk)
        handles = _run_all(ex, _conv(rt, imgs))
        assert all(h.backend == name for h in handles)
        assert clk() >= 2.0   # the spike elapsed on the manual clock
        return _values(handles), _ledger(ex)

    (_, jl), (tv, tl) = _both(run)
    assert tl == jl
    assert tl[0]["fft"]["straggle"] == 1 and "fallback" not in tl[0]["fft"]
    for h, r in zip(tv, _optical_reference(imgs, max_batch=4)):
        np.testing.assert_array_equal(h, r)   # slow, not wrong


def test_device_loss_mid_sharded_dispatch_recovers_on_survivor():
    imgs = _images(8)

    def run(rt):
        name = rt.register_chaos("sharded", name="chaos-shard",
                                 script={0: rt.Fault("device_loss",
                                                     device=1)})
        clk = rt.ManualClock()
        ex = _ex(rt, rt.BATCHED_4F, default_backend=name, max_batch=8,
                 n_devices=4, clock=clk)
        handles = _run_all(ex, _conv(rt, imgs))
        assert ex.quarantine.is_quarantined(("device", 1), ex.now())
        assert ex.quarantine.active_device_count(ex.now()) == 1
        first = _ledger(ex)
        # the next group re-scatters across the 3 survivors only
        ex.telemetry.reset()
        more = [ex.submit("fft", im) for im in _conv(rt, imgs)[:6]]
        ex.flush()
        assert ex.telemetry.devices_observed("fft") == 3
        return (_values(handles), _values(more), first,
                ex.telemetry.device_samples("fft"))

    (_, _, jl, jd), (tv, tm, tl, td) = _both(run)
    assert tl == jl and td == jd
    assert tl[0]["fft"]["device_loss"] == 1
    ref = _optical_reference(imgs, max_batch=8)
    for h, r in zip(tv, ref):
        np.testing.assert_allclose(h, r, rtol=RTOL, atol=ATOL)
    for h, r in zip(tm, ref[:6]):
        np.testing.assert_allclose(h, r, rtol=RTOL, atol=ATOL)


def test_router_replan_shrinks_fanout_around_quarantined_devices():
    imgs = _images(8)
    clk = trt.ManualClock()
    ex = _ex(trt, trt.BATCHED_4F, default_backend="sharded", max_batch=8,
             n_devices=4, clock=clk)
    router = trt.PlanRouter(ex)
    for im in imgs:
        ex.submit("fft", im)
    ex.flush()
    full = router.choose_sharding()["fft"][1]
    ex.quarantine.quarantine(("device", 2), ex.now(), reason="test")
    ex.quarantine.quarantine(("device", 3), ex.now(), reason="test")
    shrunk = router.choose_sharding()["fft"][1]
    assert shrunk == min(full, 2) and shrunk < full
    clk.advance(ex.retry.quarantine_s + ex.retry.probation_s + 1e-3)
    assert router.choose_sharding()["fft"][1] == full


def test_drift_violation_corrected_from_shadow_and_quarantined():
    imgs = _images(4)

    def run(rt):
        name = rt.register_chaos("optical-sim", name="chaos-drift",
                                 script={0: rt.Fault("drift", gain=64.0)})
        ex = _ex(rt, rt.BATCHED_4F, default_backend=name, max_batch=4,
                 clock=rt.ManualClock(), fidelity=rt.FidelityChecker())
        handles = _run_all(ex, _conv(rt, imgs))
        assert all(h.backend == "host" for h in handles)
        assert ex.fidelity.violations("fft")
        assert ex.quarantine.events[-1].reason == "fidelity-drift"
        return _values(handles), _ledger(ex)

    (_, jl), (tv, tl) = _both(run)
    assert tl[:2] == jl[:2]      # the shadow's time is the host's clock
    assert tl[0]["fft"]["drift"] == 1
    for h, r in zip(tv, _host_reference(imgs)):
        np.testing.assert_array_equal(h, r)   # corrected: host bit-equal


def test_chaos_sharded_run_matches_reference_fault_for_fault():
    """A seeded chaos run over the sharded backend (every fault kind, the
    fidelity shadow on, several flushes with the manual clock moved on
    between them) serves, faults, quarantines and recovers exactly as the
    reference's, and every frame retires.  The dispatch structure is the
    card's smoke run's at a small size: 16 frames a flush in tiles of 2
    over 4 devices."""
    imgs = _images(16, shape=(16, 16))

    def run(rt):
        name = rt.register_chaos("sharded", name="chaos-sharded-0",
                                 rate=0.3, seed=0)
        clk = rt.ManualClock()
        ex = _ex(rt, rt.BATCHED_4F, default_backend=name, max_batch=16,
                 n_devices=4, tile_k=2, clock=clk,
                 fidelity=rt.FidelityChecker())
        served, values = [], []
        for _ in range(6):
            hs = [ex.submit("fft", im) for im in _conv(rt, imgs)]
            ex.flush()
            assert all(h.ready and h.value is not None for h in hs)
            served.append([h.backend for h in hs])
            values.append(_values(hs))
            clk.advance(1.0)
        return served, values, _ledger(ex), \
            ex.telemetry.recovery_stats("fft")

    (js, jv, jl, jr), (ts, tv, tl, tr) = _both(run)
    # a drift's recovery is the shadow's host time: only counts compare
    assert ts == js and tl == jl and tr["n"] == jr["n"]
    counts = tl[0]["fft"]
    assert counts.get("device_loss", 0) and counts.get("straggle", 0)
    assert counts.get("drift", 0)
    host = _host_reference(imgs)
    optical = _optical_reference(imgs, max_batch=16)
    for backends, vals in zip(ts, tv):
        for b, v, h, o in zip(backends, vals, host, optical):
            if b == "host":
                np.testing.assert_array_equal(v, h)
            else:
                np.testing.assert_array_equal(v, o)


def test_fault_sequence_reproducible_under_manual_clock():
    imgs = _images(24, shape=(16, 16))

    def run(rt):
        name = rt.register_chaos("optical-sim", name="chaos-repro",
                                 rate=0.3, seed=7, straggle_s=0.5)
        ex = _ex(rt, rt.BATCHED_4F, default_backend=name, max_batch=4,
                 clock=rt.ManualClock(), fidelity=rt.FidelityChecker())
        handles = _run_all(ex, _conv(rt, imgs))
        return (_values(handles), [h.backend for h in handles],
                _ledger(ex)[:2])

    vals_a, be_a, led_a = run(trt)
    vals_b, be_b, led_b = run(trt)
    assert be_a == be_b and led_a == led_b
    assert led_a[0]
    for a, b in zip(vals_a, vals_b):
        np.testing.assert_array_equal(a, b)
    _, be_j, led_j = run(jrt)
    assert be_a == be_j and led_a == led_j


def test_ten_percent_fault_rate_all_frames_retire_host_close():
    imgs = _images(48, shape=(16, 16))
    name = trt.register_chaos("optical-sim", name="chaos-ten", rate=0.10,
                              seed=2)
    clk = trt.ManualClock()
    tr = trt.Tracer(clock=clk)
    ex = _ex(trt, trt.BATCHED_4F, default_backend=name, max_batch=2,
             clock=clk, tracer=tr, fidelity=trt.FidelityChecker())
    handles = _run_all(ex, imgs)
    assert all(h.ready and h.value is not None for h in handles)
    spec = trt.BATCHED_4F
    bound = trt.enob_error_bound(min(spec.dac.effective_bits,
                                     spec.adc.effective_bits), 16.0)
    for h, r in zip(_values(handles), _host_reference(imgs)):
        assert np.linalg.norm(h - r) / max(np.linalg.norm(r), 1e-12) <= bound
    assert ex.telemetry.faults_total("fft") > 0
    assert "fault" in {s.name for s in tr.spans()}
    assert tr.find("invocation")
    rec = trt.reconcile(tr.spans(), 1.0)
    assert rec["attributed_s"] >= 0.0 and "coverage" in rec


# -- the quarantine lifecycle ---------------------------------------------


def test_quarantine_window_probation_escalation_round_trip():
    q = trt.Quarantine(window_s=1.0, probation_s=0.5, patience=3)
    key = ("device", 0)
    ev = q.quarantine(key, 10.0)
    assert ev.level == 0 and ev.until == 11.0
    assert q.is_quarantined(key, 10.5) and not q.is_quarantined(key, 11.0)
    assert q.on_probation(key, 11.2) and not q.on_probation(key, 11.5)
    ev2 = q.quarantine(key, 11.2)
    assert ev2.level == 1 and ev2.until == pytest.approx(11.2 + 2.0)
    t_clean = ev2.probation_until + 0.1
    ev3 = q.quarantine(key, t_clean)
    assert ev3.level == 0 and ev3.until == pytest.approx(t_clean + 1.0)
    assert q.active(t_clean + 0.5) == (key,)
    assert q.active_device_count(t_clean + 0.5) == 1
    assert "quarantine" in q.summary(t_clean + 0.5)


def test_quarantine_straggle_strikes_and_forgiveness():
    q = trt.Quarantine(window_s=1.0, patience=3)
    key = ("category", "fft")
    assert q.note_straggle(key, 0.0) is None
    assert q.note_straggle(key, 0.1) is None
    q.note_healthy(key)
    assert q.note_straggle(key, 0.2) is None
    assert q.note_straggle(key, 0.3) is None
    ev = q.note_straggle(key, 0.4)
    assert ev is not None and ev.reason == "straggler"
    assert q.note_straggle(key, 0.5) is None


def test_retry_policy_backoff_matches_reference_stream():
    p = trt.RetryPolicy(backoff_s=1e-3, backoff_factor=2.0, jitter=0.5,
                        seed=1)
    j = jrt.RetryPolicy(backoff_s=1e-3, backoff_factor=2.0, jitter=0.5,
                        seed=1)
    b1, b2, b3 = (p.backoff_for(i) for i in (1, 2, 3))
    assert [b1, b2, b3] == [j.backoff_for(i) for i in (1, 2, 3)]
    assert 1e-3 <= b1 <= 1.5e-3
    assert 2e-3 <= b2 <= 3e-3
    assert 4e-3 <= b3 <= 6e-3
    with pytest.raises(ValueError):
        trt.RetryPolicy(max_attempts=0)


def test_trailing_median_deadline_cold_armed_and_strikes():
    det = TrailingMedianDeadline(factor=3.0, patience=2)
    assert det.deadline_s() == float("inf")
    assert not det.observe(100.0)
    assert det.deadline_s() == pytest.approx(300.0)
    det2 = TrailingMedianDeadline(factor=3.0, floor_s=0.05)
    assert det2.deadline_s(base_s=0.02) == pytest.approx(0.15)
    assert det2.observe(1.0, base_s=0.02)
    assert det2.median == float("inf")
    det3 = TrailingMedianDeadline(factor=2.0, patience=2)
    for _ in range(4):
        assert not det3.observe(1.0)
    assert det3.observe(10.0) and not det3.exhausted
    assert det3.observe(10.0) and det3.exhausted
    assert det3.median == pytest.approx(1.0)
    det3.reset_strikes()
    assert not det3.exhausted
    det3.reset()
    assert det3.deadline_s() == float("inf")


# -- lifecycle: nothing leaks on exception paths --------------------------


def test_exit_drains_held_and_inflight_groups_on_body_exception():
    imgs = _images(6)
    clk = trt.ManualClock()
    ex = _ex(trt, trt.BATCHED_4F, default_backend="optical-sim",
             max_batch=8, clock=clk)
    with pytest.raises(ValueError, match="body"):
        with trt.OffloadScheduler(ex, deadline_s=10.0, clock=clk) as sched:
            handles = [sched.submit("fft", im) for im in imgs]
            assert ex.pending == 6
            raise ValueError("body")
    assert ex.pending == 0 and ex.in_flight == 0
    assert all(h.ready and h.value is not None for h in handles)
    for h, r in zip(_values(handles), _optical_reference(imgs, max_batch=8)):
        np.testing.assert_array_equal(h, r)


def test_exit_does_not_mask_body_exception_with_backend_error():
    class _Exploding:
        name = "exploding"

        def supports(self, category, ctx):
            return True

        def run(self, category, xs, ctx, *, kernel=None, weights=None):
            raise RuntimeError("boom")   # NOT a FaultError: no retry

    trt.register_backend("exploding", _Exploding)
    ex = _ex(trt, trt.BATCHED_4F, default_backend="exploding",
             clock=trt.ManualClock())
    sched = trt.OffloadScheduler(ex, deadline_s=10.0, clock=ex._clock)
    with pytest.raises(ValueError, match="body"):
        with sched:
            sched.submit("fft", _images(1)[0])
            raise ValueError("body")
    ex2 = _ex(trt, trt.BATCHED_4F, default_backend="exploding",
              clock=trt.ManualClock())
    with pytest.raises(RuntimeError, match="boom"):
        with ex2:
            ex2.submit("fft", _images(1)[0])


def test_chaos_backend_delegates_supports_and_samples():
    be = trt.ChaosBackend("sharded", schedule=trt.FaultSchedule())
    assert be.inner_name == "sharded"
    assert be.name == "chaos-sharded"
    assert be.take_device_samples() is None
    with pytest.raises(trt.TransientDispatchError):
        trt.ChaosBackend("host", schedule=trt.FaultSchedule(
            script={0: trt.Fault("error")})).run("fft", [], None)
    with pytest.raises(trt.DeviceLostError):
        trt.ChaosBackend("host", schedule=trt.FaultSchedule(
            script={0: trt.Fault("device_loss")})).run(
                "fft", [], trt.BackendContext(spec=trt.BATCHED_4F))


def test_drift_scales_outputs_on_their_own_device():
    be = trt.ChaosBackend("host", schedule=trt.FaultSchedule(
        script={0: trt.Fault("drift", gain=8.0)}))
    ctx = trt.BackendContext(spec=trt.BATCHED_4F)
    x = _images(1, shape=(8, 8))[0]
    (out,), _ = be.run("fft", [x], ctx)
    (ref,), _ = trt.get_backend("host").run("fft", [x], ctx)
    assert out.device == ref.device
    torch.testing.assert_close(out, ref * 8.0, rtol=0, atol=0)


def _retire_spy(ex):
    retired = []
    orig = ex._retire

    def spy(g):
        retired.append((g.wkey, [p.call_id for p in g.chunk]))
        orig(g)

    ex._retire = spy
    return retired


@pytest.mark.parametrize("shared", [False, True])
def test_chaos_straggler_does_not_stall_other_engine_window(shared):
    imgs = _images(8)
    k = torch.zeros(32, 32)
    k[0, 0] = 1.0
    name = trt.register_chaos(
        "optical-sim", name=f"chaos-win-{int(shared)}",
        script={0: trt.Fault("straggle", delay_s=5.0)})
    clk = trt.ManualClock()
    ex = _ex(trt, trt.BATCHED_4F, max_batch=2, pipeline_depth=2, clock=clk,
             shared_window=shared)
    retired = _retire_spy(ex)
    for im in imgs[:4]:
        ex.submit("fft", im, backend=name)
    ex.flush_async()
    # on the CPU a dispatch returns with its results computed, but the
    # window still holds it until it is retired
    assert [g.wkey for g in ex._inflight] == [("fft", name)] * 2
    for im in imgs[4:]:
        ex.submit("conv", im, kernel=k, backend="optical-sim")
    ex.flush_async()
    forced = [w for w, _ in retired]
    if shared:
        assert ("fft", name) in forced
    else:
        assert forced == []
        assert [g.wkey for g in ex._inflight] == \
            [("fft", name)] * 2 + [("conv", "optical-sim")] * 2
    ex.drain()
    for wkey in {w for w, _ in retired}:
        ids = [i for w, grp in retired for i in grp if w == wkey]
        assert ids == sorted(ids)
    assert ex.telemetry.fault_counts["fft"]["straggle"] == 1
