"""Delta-encoded DAC staging in the port (``runtime.residency``,
``executor``, ``sharded``, ``router``) against the reference's
``tests/test_delta.py``.

Both packages get the same frames: the reference test's ``jax.random``
images and drifts, drawn once and handed to the port as float32 tensors.
Each mirror asserts the reference test's invariants on the port, and
holds the port to the reference's own numbers on the same inputs:

* slot classification (``classify_operand``, ``invalidate_device``): the
  same labels and write scales, exactly (pure Python over the same
  codes);
* the delta-staged flush's modeled cost: the reference's
  ``batched_step_cost(resident_frames=, delta_fractions=)`` at the
  measured flips (rtol 1e-12, as the reference holds itself), and the
  port's per-call cost equal to the reference's;
* delta-staged == re-staged, bit-equal, on ``host`` and ``optical-sim``
  (the north star's bit-equality);
* a placed re-stage donates the stale frame buffer;
* the router's deadline loop weighs the delta rate in, choosing the
  reference's sharding.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.runtime as jrt
from repro.core.accelerator import PROTOTYPE_4F as J4F
from repro.core.conversion import ConverterSpec as JConverterSpec
from repro_torch import runtime as trt
from repro_torch.core.accelerator import PROTOTYPE_4F as T4F
from repro_torch.core.conversion import (ConverterSpec, code_signature,
                                         delta_write_scale,
                                         expected_flip_fraction)


def _spec(base, converter):
    laned = dataclasses.replace(
        base, name="laned-4f", interface_latency_s=1.0e-3,
        dac_lanes=48, adc_lanes=48, slm_interface_hz=100e6,
        camera_interface_hz=100e6, device_sync_s=1.0e-5)
    adc = converter(name="hifi-adc", kind="adc", bits=12, rate_hz=5.0e8,
                    power_w=0.060, enob=10.5)
    return dataclasses.replace(laned, adc=adc)


JSPEC, TSPEC = _spec(J4F, JConverterSpec), _spec(T4F, ConverterSpec)
BITS = TSPEC.dac.bits


def _imgs(n, shape=(32, 32), seed=0):
    """The reference test's images, drawn once in jax."""
    key = jax.random.PRNGKey(seed)
    return [np.asarray(jax.random.uniform(jax.random.fold_in(key, i),
                                          shape)) for i in range(n)]


def _drift(img, i, scale=0.01):
    key = jax.random.fold_in(jax.random.PRNGKey(1234), i)
    return np.asarray(img + scale * jax.random.uniform(key, img.shape))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _flush(ex, category, imgs, convert, **kw):
    hs = [ex.submit(category, convert(im), **kw) for im in imgs]
    ex.flush()
    return [np.asarray(h.value) for h in hs], [h.cost for h in hs]


def _slot(device):
    return (device, "fft", "frame", trt.operating_point(TSPEC),
            ((32, 32), "float32"), 0)


def _jslot(device):
    return (device, "fft", "frame", jrt.operating_point(JSPEC),
            ((32, 32), "float32"), 0)


def test_classify_operand_hit_delta_full():
    """``test_delta.py::test_classify_operand_hit_delta_full``."""
    img = _imgs(1)[0]
    other = _imgs(1, seed=77)[0]
    steps = [(("k", 0), img), (("k", 0), img), (("k", 1), _drift(img, 0)),
             (("k", 2), other)]
    tcache = trt.ResidencyCache(capacity_bytes=1 << 20)
    jcache = jrt.ResidencyCache(capacity_bytes=1 << 20)
    got = [tcache.classify_operand(_slot("host"), ck, _t(x), TSPEC,
                                   category="fft") for ck, x in steps]
    want = [jcache.classify_operand(_jslot("host"), ck, jax.numpy.asarray(x),
                                    JSPEC, category="fft")
            for ck, x in steps]
    assert got == want
    assert got[0] == ("full", 1.0) and got[1] == ("hit", 0.0)
    label, scale = got[2]
    assert label == "delta"
    assert 1.0 / BITS <= scale <= delta_write_scale(trt.DELTA_THRESHOLD,
                                                    BITS)
    assert tcache.counts["fft"]["delta"] == 1
    assert got[3] == ("full", 1.0)


def test_invalidate_device_drops_slot_signatures():
    """``test_delta.py::test_invalidate_device_drops_slot_signatures``."""
    img = _imgs(1)[0]
    cache = trt.ResidencyCache(capacity_bytes=1 << 20)
    slot = _slot(("device", 1))
    cache.classify_operand(slot, ("k", 0), _t(img), TSPEC, category="fft")
    cache.invalidate_device(("device", 1))
    assert cache.classify_operand(slot, ("k", 1), _t(_drift(img, 0)), TSPEC,
                                  category="fft") == ("full", 1.0)


def test_delta_staged_flush_priced_by_measured_flip():
    """``test_delta.py::test_delta_staged_flush_priced_by_measured_flip``:
    the dispatched cost IS ``batched_step_cost(resident_frames=4,
    delta_fractions=...)`` at the measured flips, and the reference's."""
    imgs = _imgs(6)
    drift = list(imgs)
    for i in (0, 3):
        drift[i] = _drift(imgs[i], i)
    fracs = [expected_flip_fraction(code_signature(imgs[i], BITS),
                                    code_signature(drift[i], BITS))
             for i in (0, 3)]
    assert all(0.0 < f <= trt.DELTA_THRESHOLD for f in fracs)
    scales = tuple(delta_write_scale(f, BITS) for f in fracs)

    ex = trt.OffloadExecutor(TSPEC, max_batch=8, residency=True,
                             device="cpu")
    _flush(ex, "fft", imgs, _t)
    _, costs = _flush(ex, "fft", drift, _t)
    n = imgs[0].size
    want = ex.spec.batched_step_cost(n, n, batch=len(drift),
                                     pipeline_depth=ex.pipeline_depth,
                                     resident_frames=4,
                                     delta_fractions=scales)
    full = ex.spec.batched_step_cost(n, n, batch=len(drift),
                                     pipeline_depth=ex.pipeline_depth)
    got = costs[0]
    np.testing.assert_allclose(got.total_s, want.total_s / len(drift),
                               rtol=1e-12)
    np.testing.assert_allclose(got.dac_s * len(drift), want.dac_s,
                               rtol=1e-9)
    assert 0.0 < got.dac_s * len(drift) < full.dac_s
    assert ex.residency.counts["fft"]["delta"] == 2
    assert ex.telemetry.delta_rate("fft") == pytest.approx(2 / 8)
    assert ex.telemetry.mean_flip_fraction("fft") == \
        pytest.approx(sum(fracs) / 2)

    jex = jrt.OffloadExecutor(JSPEC, max_batch=8, residency=True)
    _flush(jex, "fft", imgs, jax.numpy.asarray)
    _, jcosts = _flush(jex, "fft", drift, jax.numpy.asarray)
    assert got.total_s == jcosts[0].total_s
    assert got.dac_s == jcosts[0].dac_s


@pytest.mark.parametrize("backend", ["host", "optical-sim"])
def test_delta_staged_equals_restaged(backend):
    """``test_delta.py::test_delta_staged_equals_restaged``: bit-equal."""
    imgs = _imgs(6)
    drift = [_drift(im, i) if i % 3 == 0 else im
             for i, im in enumerate(imgs)]
    plain = trt.OffloadExecutor(TSPEC, max_batch=8, default_backend=backend,
                                device="cpu")
    restaged, _ = _flush(plain, "fft", drift, _t)
    ex = trt.OffloadExecutor(TSPEC, max_batch=8, default_backend=backend,
                             residency=True, device="cpu")
    _flush(ex, "fft", imgs, _t)
    delta_staged, _ = _flush(ex, "fft", drift, _t)
    for d, r in zip(delta_staged, restaged):
        np.testing.assert_array_equal(d, r)
    _, costs = _flush(ex, "fft", drift, _t)
    if backend == "optical-sim":
        assert costs[0].dac_s == 0.0


def test_commit_placement_donates_changed_frames(monkeypatch):
    """``test_delta.py::test_commit_placement_donates_changed_frames``:
    two simulated devices, both the CPU."""
    import repro_torch.runtime.sharded as sh
    monkeypatch.setattr(sh, "shard_devices",
                        lambda n, home: [torch.device("cpu")] * n)
    be = trt.ShardedOpticalBackend(inner="host")
    ctx = trt.BackendContext(spec=TSPEC, n_devices=2)
    ctx.residency = trt.ResidencyCache(capacity_bytes=1 << 22)
    imgs = [_t(x) for x in _imgs(4)]
    assert be.commit_placement("fft", imgs, ctx) is not None
    be.run("fft", imgs, ctx)
    op = trt.operating_point(TSPEC)
    dead_key = ("frame-shard", op, (ctx.content_key(imgs[0]),))
    assert dead_key in ctx.residency.resident_keys()

    drift = [_t(_drift(_imgs(1)[0], 0))] + imgs[1:]
    be.commit_placement("fft", drift, ctx)
    assert ctx.residency.counts["fft"]["donation"] == 1
    assert dead_key not in ctx.residency.resident_keys()
    be.run("fft", drift, ctx)
    frame_shards = [k for k in ctx.residency.resident_keys()
                    if k[0] == "frame-shard"]
    assert len(frame_shards) == 4
    for im in imgs[1:]:
        assert ("frame-shard", op,
                (ctx.content_key(im),)) in frame_shards


def test_router_replan_weighs_delta_rate():
    """``test_delta.py::test_router_replan_weighs_delta_rate``, with the
    reference's choices on the same telemetry."""
    def _router(rt, spec, flip, **kw):
        ex = rt.OffloadExecutor(spec, max_batch=16, **kw)
        ex.telemetry.record("fft", "optical-sim", calls=16,
                            samples_in=16 * 4096, samples_out=16 * 4096,
                            wall_s=0.01)
        for _ in range(8):
            ex.telemetry.note_delta("fft", flip_fraction=flip)
        return rt.PlanRouter(ex)

    scale = delta_write_scale(0.05, BITS)
    priced = TSPEC.batched_step_cost(4096, 4096, batch=16, pipeline_depth=2,
                                     n_devices=1, tile_k=16,
                                     delta_fractions=(scale,) * 16)
    full = TSPEC.batched_step_cost(4096, 4096, batch=16, pipeline_depth=2,
                                   n_devices=1, tile_k=16)
    deadline = (priced.total_s + full.total_s) / 2
    got = [_router(trt, TSPEC, flip, device="cpu").choose_sharding(
        deadline)["fft"] for flip in (0.05, None)]
    want = [_router(jrt, JSPEC, flip).choose_sharding(deadline)["fft"]
            for flip in (0.05, None)]
    assert got == want
    assert got[0][0] == 16
    assert got[1][0] < 16
