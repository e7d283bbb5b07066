"""The port's offload runtime as a whole, on the CPU, against the reference.

The reference's ``OffloadExecutor``/``PlanRouter`` and the port's run the
same frames (made with numpy from a seed) on ``host``, ``optical-sim`` and
``ideal`` for ``fft``, ``conv`` and ``matmul``.  Tolerances, and why:

* modeled prices (``StepCost``), tile choices, telemetry counts, plans and
  router decisions are pure Python in both packages: exactly equal;
* ``host`` and ``ideal`` values come from two FFT/matmul libraries in
  float32: rtol 1e-5 / atol 1e-5*max;
* ``optical-sim`` values pass an auto-ranged ADC whose input differs in
  the last float32 bits between the packages (the reference runs fft2 on
  the CPU, the port its DFT kernels' plain matmul form), so a value may
  land one ADC step of its frame's full scale away: fft is held to
  atol 2e-4*max (the pipeline's own bound) plus one step, matmul to one
  step of each of its two differential readouts, conv to four steps (its
  interferometric recovery sums four captures, each of which may land one
  step away).
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accelerator as jacc
from repro.core import conversion as jconv
from repro import runtime as jrt
from repro_torch.core import accelerator as tacc
from repro_torch.core import conversion as tconv
from repro_torch import runtime as trt
from repro_torch.runtime import executor as texec


def _laned(acc):
    """The reference tests' lane-parallel 4f spec, in either package."""
    return dataclasses.replace(
        acc.PROTOTYPE_4F, name="laned-4f", interface_latency_s=1.0e-3,
        dac_lanes=48, adc_lanes=48, slm_interface_hz=100e6,
        camera_interface_hz=100e6)


def _mvm(acc, conv):
    adc = conv.ConverterSpec(name="hifi-adc", kind="adc", bits=12,
                             rate_hz=5.0e8, power_w=0.060, enob=10.5)
    return dataclasses.replace(acc.ANDERSON_MVM, adc=adc)


def _frames(n, shape=(32, 32), seed=0, signed=False):
    rng = np.random.default_rng(seed)
    out = [rng.random(shape, dtype=np.float32) for _ in range(n)]
    return [2.0 * x - 1.0 for x in out] if signed else out


def _pair_executors(category, **kw):
    if category == "matmul":
        js, ts = _mvm(jacc, jconv), _mvm(tacc, tconv)
    else:
        js, ts = _laned(jacc), _laned(tacc)
    jkw, tkw = dict(kw), dict(kw)
    limit = kw.pop("budget", None)
    if limit is not None:
        jkw.pop("budget")
        tkw.pop("budget")
        jkw["mem_budget"] = jrt.MemoryBudget(limit)
        tkw["mem_budget"] = trt.MemoryBudget(limit)
    return (jrt.OffloadExecutor(js, **jkw),
            trt.OffloadExecutor(ts, device="cpu", **tkw))


def _operands(category):
    rng = np.random.default_rng(5)
    if category == "conv":
        k = np.zeros((32, 32), np.float32)
        k[:3, :3] = 0.1 * rng.standard_normal((3, 3)).astype(np.float32)
        k[0, 0] += 0.6
        return _frames(5, signed=True), dict(kernel=k)
    if category == "matmul":
        w = rng.standard_normal((24, 8)).astype(np.float32)
        return _frames(5, shape=(6, 24), signed=True), dict(weights=w)
    return _frames(5), {}


def _run(ex, frames, category, backend, operand, convert):
    op = {k: convert(v) for k, v in operand.items()}
    hs = [ex.submit(category, convert(x), backend=backend, **op)
          for x in frames]
    ex.flush()
    return hs


def _tolerance(category, backend, want, ex_spec):
    top = float(np.abs(want).max())
    if backend != "optical-sim":
        return 1e-5 * top
    levels = (1 << ex_spec.adc.bits) - 1
    if category == "fft":
        return 2e-4 * top + top / levels
    if category == "matmul":
        return 2.0 * top / levels
    # conv: the recovery combines four captures, each one step off at most
    return 4.0 * top / levels


# Budget of 64 KiB: a 32x32 frame's working set is 16 KiB, two tiles are
# in flight, so 5-deep groups stream as tiles of 2 (2 + 2 + 1).
_TILED = 128 << 10


@pytest.mark.parametrize("backend", ["host", "optical-sim", "ideal"])
@pytest.mark.parametrize("category", ["fft", "conv", "matmul"])
def test_slice_matches_reference(category, backend):
    frames, operand = _operands(category)
    jex, tex = _pair_executors(category, max_batch=4, pipeline_depth=2,
                               budget=_TILED)
    jh = _run(jex, frames, category, backend, operand, jnp.asarray)
    th = _run(tex, frames, category, backend, operand, torch.from_numpy)
    for j, t in zip(jh, th):
        want = np.asarray(j.value)
        got = t.value.numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5 if backend != \
                                   "optical-sim" else 0.0,
                                   atol=_tolerance(category, backend, want,
                                                   tex.spec))
        assert (t.backend, t.batch) == (j.backend, j.batch)
        if backend != "host":  # host prices are measured walls
            assert dataclasses.asdict(t.cost) == dataclasses.asdict(j.cost)
    for key, st in jex.telemetry.stats.items():
        ts = tex.telemetry.stats[key]
        assert (ts.calls, ts.invocations, ts.samples_in, ts.samples_out) == \
            (st.calls, st.invocations, st.samples_in, st.samples_out)
    assert tex.telemetry.samples_per_call(category) == \
        jex.telemetry.samples_per_call(category)
    assert tex.telemetry.tile_sizes_observed(category) == \
        jex.telemetry.tile_sizes_observed(category)
    w = operand.get("weights")
    tile = tex.resolve_tile_k(category, torch.from_numpy(frames[0]), 5,
                              weights=None if w is None
                              else torch.from_numpy(w))
    assert tile == jex.resolve_tile_k(category, jnp.asarray(frames[0]), 5,
                                      weights=None if w is None
                                      else jnp.asarray(w))
    assert tile == (5 if category == "matmul" else 2)


@pytest.mark.parametrize("category", ["fft", "conv"])
def test_residency_hits_priced_like_reference(category):
    frames, operand = _operands(category)
    jex, tex = _pair_executors(category, max_batch=8, residency=True)
    for _ in range(2):  # the second flush is a residency hit
        jh = _run(jex, frames, category, "optical-sim", operand, jnp.asarray)
        th = _run(tex, frames, category, "optical-sim", operand,
                  torch.from_numpy)
        for j, t in zip(jh, th):
            assert dataclasses.asdict(t.cost) == dataclasses.asdict(j.cost)
    assert th[0].cost.dac_s == 0.0
    assert tex.telemetry.residency_hit_rate(category) == \
        jex.telemetry.residency_hit_rate(category)


def test_fidelity_reports_match_reference():
    frames, operand = _operands("conv")
    jf, tf = jrt.FidelityChecker(), trt.FidelityChecker()
    jex, tex = _pair_executors("conv", max_batch=8)
    jex.fidelity, tex.fidelity = jf, tf
    _run(jex, frames, "conv", "optical-sim", operand, jnp.asarray)
    _run(tex, frames, "conv", "optical-sim", operand, torch.from_numpy)
    (rj,), (rt,) = jf.reports, tf.reports
    assert (rt.ok, rt.batch, rt.bound, rt.enob) == \
        (rj.ok, rj.batch, rj.bound, rj.enob)
    np.testing.assert_allclose(rt.rel_err, rj.rel_err, rtol=0.1)


def _synthetic_telemetry(ex):
    """Identical recorded traffic for both packages' routers."""
    tel = ex.telemetry
    n = 64 * 64
    tel.record("fft", "host", calls=12, samples_in=12 * n,
               samples_out=12 * n, wall_s=0.03)
    tel.record("fft", "host", calls=4, samples_in=4 * n, samples_out=4 * n,
               wall_s=0.01)
    tel.record("conv", "host", calls=6, samples_in=6 * n, samples_out=6 * n,
               wall_s=0.2)
    for occ in (1, 2, 2):
        tel.note_window("fft", "optical-sim", in_flight=occ, depth=2)
    tel.note_window("conv", "host", in_flight=1, depth=2)


@pytest.mark.parametrize("deadline_s", [None, 5e-3, 5e-2])
def test_router_replan_decisions_match_reference(deadline_s):
    jex, tex = _pair_executors("fft", max_batch=16, pipeline_depth=2,
                               budget=1 << 20)
    routers = []
    for rt, ex in ((jrt, jex), (trt, tex)):
        _synthetic_telemetry(ex)
        ex.set_max_batch("conv", 8)         # an operator pin
        router = rt.PlanRouter(ex)
        plan = router.replan(deadline_s=deadline_s)
        routers.append((router, plan, ex))
    (jr, jp, jx), (tr, tp, tx) = routers
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tr.routes == jr.routes
    assert dict(tx.category_max_batches()) == dict(jx.category_max_batches())
    assert dict(tx.category_tile_ks()) == dict(jx.category_tile_ks())
    assert dict(tx.category_windows()) == dict(jx.category_windows())
    assert tr.choose_sharding(deadline_s) == jr.choose_sharding(deadline_s)


# --- the port's own runtime behaviour (mirrors tests/test_runtime.py) --------


def _ex(**kw):
    return trt.OffloadExecutor(_laned(tacc), device="cpu", **kw)


def _tframes(n):
    return [torch.from_numpy(x) for x in _frames(n)]


def test_flush_async_readiness_ordering_and_drain():
    imgs = _tframes(10)
    ex = _ex(max_batch=4, pipeline_depth=2)
    hs = [ex.submit("fft", im) for im in imgs]
    done = ex.flush_async()
    assert done == hs                     # filled at once, in submit order
    assert all(h.ready and h.done() for h in hs)   # the CPU is synchronous
    assert ex.in_flight <= 2
    ex.drain()
    assert ex.in_flight == 0
    st = ex.telemetry.stats[("fft", "optical-sim")]
    assert st.invocations == 3 and st.calls == 10  # 4 + 4 + 2
    ser = _ex(max_batch=1, pipeline_depth=1)
    ss = [ser.submit("fft", im) for im in imgs]
    ser.flush()
    for hb, hs1 in zip(hs, ss):
        torch.testing.assert_close(hb.value, hs1.value, rtol=1e-5, atol=1e-7)


def test_wait_get_and_interleaved_submits():
    imgs = _tframes(6)
    ex = _ex(max_batch=2, pipeline_depth=2)
    first = [ex.submit("fft", im) for im in imgs[:4]]
    ex.flush_async()
    assert ex.in_flight == 2
    second = [ex.submit("fft", im) for im in imgs[4:]]
    assert ex.pending == 2 and not any(h.ready for h in second)
    ex.flush_async()
    assert ex.in_flight <= 2
    assert first[0].wait() is first[0] and first[0].done()
    assert second[-1].get() is second[-1].value
    ex.drain()
    st = ex.telemetry.stats[("fft", "optical-sim")]
    assert st.calls == 6 and st.invocations == 3
    recorded = (st.calls, st.invocations, st.wall_s)
    ex.drain()                                # idempotent
    assert first[1].wait().value is first[1].value
    assert (st.calls, st.invocations, st.wall_s) == recorded


def test_executor_defaults_to_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.OffloadExecutor(trt.BATCHED_4F)
    assert _ex().device == torch.device("cpu")


def test_results_ready_event_is_none_on_cpu():
    ex = _ex(max_batch=4)
    hs = [ex.submit("fft", im) for im in _tframes(3)]
    ex.flush_async()
    assert all(h._event is None and h.done() for h in hs)
    assert texec._is_ready(None)


def test_sharded_dispatch_is_a_later_slice():
    """Sharded dispatch was stubbed out until ``runtime/sharded.py`` was
    ported; now every entry point that raised runs (its parity tests are
    ``tests/test_torch_sharded.py``)."""
    ex = _ex(n_devices=2, default_backend="sharded", max_batch=4)
    ex.set_n_devices("fft", 1)
    ex.set_n_devices("fft", 2)
    assert ex.n_devices_for("fft") == 2
    hs = [ex.submit("fft", im) for im in _tframes(3)]
    ex.flush()
    assert all(h.backend == "sharded" for h in hs)
    assert ex.telemetry.devices_observed("fft") == 2
    for name in ("sharded", "sharded-host", "sharded-ideal"):
        assert trt.get_backend(name).name == name


def test_submit_moves_numpy_operands_and_keeps_groups():
    ex = _ex(max_batch=8)
    k = np.zeros((32, 32), np.float32)
    k[0, 0] = 1.0
    hs = [ex.submit("conv", x, kernel=k, backend="host")
          for x in _frames(3)]
    ex.flush()
    assert all(isinstance(h.value, torch.Tensor) for h in hs)
    # one numpy kernel object -> one device tensor -> one group
    assert ex.telemetry.stats[("conv", "host")].invocations == 1


def test_content_key_follows_in_place_writes():
    ctx = _ex().ctx
    t = torch.arange(16, dtype=torch.float32)
    k0 = ctx.content_key(t)
    assert ctx.content_key(t) == k0           # memoized
    t.add_(1.0)                               # in place: _version moves
    k1 = ctx.content_key(t)
    assert k1 != k0
    assert k1 == ctx.content_key(torch.arange(16, dtype=torch.float32) + 1)


def test_retry_exhaustion_falls_back_to_host():
    class Flaky(trt.OpticalSimBackend):
        name = "flaky"

        def run(self, category, xs, ctx, **kw):
            raise trt.TransientDispatchError("dropped handshake")

    trt.register_backend("flaky", Flaky)
    # the executor's clock stands still, so the quarantine window (0.25 s)
    # cannot lapse while the host frames below run on a busy machine
    ex = _ex(max_batch=4, retry=trt.RetryPolicy(max_attempts=2,
                                                backoff_s=0.0),
             clock=trt.ManualClock())
    imgs = _tframes(3)
    hs = [ex.submit("fft", im, backend="flaky") for im in imgs]
    ex.flush()
    ref = [ex.submit("fft", im, backend="host") for im in imgs]
    ex.flush()
    for h, r in zip(hs, ref):
        assert h.backend == "host"
        torch.testing.assert_close(h.value, r.value, rtol=0, atol=0)
    assert ex.quarantine.is_quarantined(("category", "fft"), ex.now())


def test_tracer_spans_cover_each_invocation():
    tracer = trt.Tracer()
    ex = _ex(max_batch=2, tracer=tracer)
    for im in _tframes(4):
        ex.submit("fft", im)
    ex.flush()
    inv = [s for s in tracer.spans() if s.name == "invocation"]
    assert len(inv) == 2
    assert trt.drift_report(tracer.spans()).invocations == 2


def test_warm_primes_without_recording():
    ex = _ex(max_batch=4)
    x = _tframes(1)[0]
    ex.warm("fft", x)
    assert not ex.telemetry.stats and ex.ctx.pipeline_depth == 2
    with pytest.raises(ValueError):
        ex.warm("conv", x)                    # conv needs kernel=


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.kernels\n"
            "import repro_torch.runtime, repro_torch.convert\n"
            "import repro_torch.models, repro_torch.configs\n"
            "import repro_torch.models.moe, repro_torch.models.attention\n"
            "import repro_torch.models.model, repro_torch.models.params\n"
            "import repro_torch.configs.seamless_m4t_large_v2\n"
            "import repro_torch.configs.llava_next_34b\n"
            "import repro_torch.casestudy.planner_table\n"
            "import repro_torch.serving, repro_torch.launch.serve\n"
            "import repro_torch.runtime.scheduler\n"
            "import repro_torch.optim, repro_torch.train, repro_torch.data\n"
            "import repro_torch.checkpoint, repro_torch.distributed.fault\n"
            "import repro_torch.launch.train, repro_torch.kernels.adc_dac\n"
            "import repro_torch.runtime.sharded, "
            "repro_torch.runtime.trace_export\n"
            "import repro_torch.distributed.sharding\n"
            "import repro_torch.distributed.compat, "
            "repro_torch.distributed.specs\n"
            "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
            "import repro_torch.checkpoint.manager\n"
            "import repro_torch.casestudy.roofline, "
            "repro_torch.casestudy.experiments\n"
            "import repro_torch.casestudy.run\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.') or m == 'benchmarks' or "
            "m.startswith('benchmarks.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


def test_optical_conv_batched_equals_looped_where_the_reference_does_not():
    """The case at which the reference's slow property test
    ``test_group_sharded_equivalence_property`` fails on its own tree:
    optical-sim conv, 15x13 frames, 2 calls, max_batch 2, one device.  The
    reference's batched and looped results differ there by up to 2.6e-4
    against its rtol = atol = 1e-5; the port's, on the same frames and
    kernel (made as ``tests/test_sharded.py`` makes them), meet 1e-5 —
    on the CPU they are bit-equal.  Nothing in the reference is relaxed:
    this runs the port only."""
    import jax
    shape = (15, 13)
    key = jax.random.PRNGKey(0)
    imgs = [np.array(jax.random.uniform(jax.random.fold_in(key, i), shape))
            for i in range(2)]
    h, w = shape
    kernel = np.zeros(shape, np.float32)
    kernel[0, 0], kernel[1, 2 % w] = 0.5, 0.25
    kernel[h - 1, 1 % w], kernel[2 % h, 0] = 0.15, 0.1
    adc = tconv.ConverterSpec(name="hifi-adc", kind="adc", bits=12,
                              rate_hz=5.0e8, power_w=0.060, enob=10.5)
    spec = dataclasses.replace(_laned(tacc), adc=adc, device_sync_s=1.0e-5)

    def run(max_batch):
        ex = trt.OffloadExecutor(spec, max_batch=max_batch,
                                 default_backend="optical-sim", device="cpu")
        hs = [ex.submit("conv", torch.from_numpy(im),
                        kernel=torch.from_numpy(kernel)) for im in imgs]
        ex.flush()
        return [hd.value for hd in hs]

    for b, l in zip(run(2), run(1)):
        torch.testing.assert_close(b, l, rtol=1e-5, atol=1e-5)
