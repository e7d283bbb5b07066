"""The port's sharded offload against the reference's, on the CPU.

Mirrors ``tests/test_sharded.py``.  The same frames (made with numpy from
a seed) go through ``repro.runtime`` and ``repro_torch.runtime``; the
invariant is the reference's,

    sharded  ==  single-device batched  ==  looped per-frame,

held inside the port at the reference's own bounds (group sharding: rtol
= atol = 1e-5; frame sharding: rtol 1e-4 / atol 1e-5 on digital inners,
a 2 % relative norm on the optical simulator, 5 % for row-tiled optical
matmul), and the port's sharded result is held to the reference's
sharded result on the same frames:

* ``host`` and ``ideal`` at the same bounds;
* ``optical-sim`` at the cross-package bound of ``test_torch_runtime.py``
  (its module docstring says why: the auto-ranged ADC's input differs in
  the last float32 bits between the reference's fft2 and the port's DFT
  kernels' plain matmul form, so a value may land one ADC step away — the
  sharded split adds nothing to it).

Modeled prices, device samples, shard sizes, halos and router decisions
are pure Python in both packages and must be equal.  The reference's
forced-XLA-device subprocess tests become in-process tests here: the
sharded module's ``shard_devices`` is monkeypatched to hand out four
``torch.device("cpu")`` handles, which runs the placed route (copies,
per-device residency, placements, gathers) on the CPU.  The reference's
three hypothesis properties are fixed example grids here, so the count is
steady.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as jrt
from repro.core import accelerator as jacc
from repro.core import conversion as jconv
from repro_torch import runtime as trt
from repro_torch.core import accelerator as tacc
from repro_torch.core import conversion as tconv
from repro_torch.distributed import sharding as tsharding
from repro_torch.runtime import sharded as tsharded

SHARDED_OF = {"host": "sharded-host", "optical-sim": "sharded",
              "ideal": "sharded-ideal"}


def _laned(acc):
    return dataclasses.replace(
        acc.PROTOTYPE_4F, name="laned-4f", interface_latency_s=1.0e-3,
        dac_lanes=48, adc_lanes=48, slm_interface_hz=100e6,
        camera_interface_hz=100e6, device_sync_s=1.0e-5)


def _hifi(conv):
    return conv.ConverterSpec(name="hifi-adc", kind="adc", bits=12,
                              rate_hz=5.0e8, power_w=0.060, enob=10.5)


def _spec(acc, conv):
    """``tests/test_sharded.py``'s SPEC in either package."""
    return dataclasses.replace(_laned(acc), adc=_hifi(conv))


def _mvm(acc, conv):
    return dataclasses.replace(acc.ANDERSON_MVM, adc=_hifi(conv),
                               device_sync_s=1.0e-6)


SPEC = _spec(tacc, tconv)
JSPEC = _spec(jacc, jconv)


def _frames(n, shape, seed=0, signed=False):
    rng = np.random.default_rng(seed)
    out = [rng.random(shape, dtype=np.float32) for _ in range(n)]
    return [2.0 * x - 1.0 for x in out] if signed else out


def _kernel(shape):
    """Small-support kernel incl. wrap-around rows (negative circular
    offsets), so overlap-save needs halo on BOTH sides of a tile."""
    h, w = shape
    k = np.zeros(shape, np.float32)
    k[0, 0], k[1, 2 % w], k[h - 1, 1 % w], k[2 % h, 0] = 0.5, 0.25, 0.15, 0.1
    return k


def _trun(backend, category, frames, spec=SPEC, *, max_batch, n_devices=1,
          shard_mode="group", kernel=None, weights=None, tile_k=None,
          **kw):
    ex = trt.OffloadExecutor(spec, max_batch=max_batch, n_devices=n_devices,
                             default_backend=backend, shard_mode=shard_mode,
                             tile_k=tile_k, device="cpu", **kw)
    op = {}
    if kernel is not None:
        op["kernel"] = torch.from_numpy(kernel)
    if weights is not None:
        op["weights"] = torch.from_numpy(weights)
    hs = [ex.submit(category, torch.from_numpy(x), **op) for x in frames]
    ex.flush()
    return hs, ex


def _jrun(backend, category, frames, spec=JSPEC, *, max_batch, n_devices=1,
          shard_mode="group", kernel=None, weights=None, tile_k=None):
    ex = jrt.OffloadExecutor(spec, max_batch=max_batch, n_devices=n_devices,
                             default_backend=backend, shard_mode=shard_mode,
                             tile_k=tile_k)
    op = {}
    if kernel is not None:
        op["kernel"] = jnp.asarray(kernel)
    if weights is not None:
        op["weights"] = jnp.asarray(weights)
    hs = [ex.submit(category, jnp.asarray(x), **op) for x in frames]
    ex.flush()
    return hs, ex


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-9))


def _cross_package(got, want, category, backend, spec):
    """The port against the reference on the same frames: the group bound
    for digital inners, the ADC-step bound for the optical simulator."""
    got, want = np.asarray(got), np.asarray(want)
    top = float(np.abs(want).max())
    if backend != "optical-sim":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * top)
        return
    levels = (1 << spec.adc.bits) - 1
    steps = 4.0 if category == "conv" else 1.0
    extra = 2e-4 * top if category == "fft" else 0.0
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=extra + steps * top / levels)


# --- the runtime-equivalence invariant -----------------------------------------


def check_group_equivalence(backend, category, shape, calls, max_batch,
                            n_devices, tile_k=None):
    frames = _frames(calls, shape)
    kernel = _kernel(shape) if category == "conv" else None
    sharded, exs = _trun(SHARDED_OF[backend], category, frames,
                         max_batch=max_batch, n_devices=n_devices,
                         kernel=kernel, tile_k=tile_k)
    batched, _ = _trun(backend, category, frames, max_batch=max_batch,
                       kernel=kernel)
    looped, _ = _trun(backend, category, frames, max_batch=1, kernel=kernel)
    ref, jex = _jrun(SHARDED_OF[backend], category, frames,
                     max_batch=max_batch, n_devices=n_devices,
                     kernel=kernel, tile_k=tile_k)
    for hs, hb, hl, hr in zip(sharded, batched, looped, ref):
        _close(hs.value, hb.value)
        _close(hb.value, hl.value)
        _cross_package(hs.value, hr.value, category, backend, SPEC)
        assert (hs.backend, hs.batch) == (hr.backend, hr.batch)
        if backend != "host":    # host prices are measured walls
            assert dataclasses.asdict(hs.cost) == dataclasses.asdict(hr.cost)
    # every device that took a shard is visible in telemetry, and the
    # shards jointly carried exactly the submitted boundary traffic
    per_dev = exs.telemetry.device_samples(category)
    assert per_dev == jex.telemetry.device_samples(category)
    chunk = min(max_batch, calls)
    tile = chunk if tile_k is None else max(1, min(tile_k, chunk))
    assert exs.telemetry.devices_observed(category) == min(n_devices, tile)
    assert sum(s for s, _ in per_dev.values()) == sum(f.size for f in frames)
    if tile_k is not None:
        assert max(exs.telemetry.tile_sizes_observed(category)) <= tile


GROUP_CASES = [
    # (backend, category, shape, calls, max_batch, n_devices, tile_k): the
    # reference's anchor grid, ragged tails and tile tails throughout
    ("host", "fft", (16, 12), 5, 3, 2, None),
    ("host", "conv", (16, 12), 7, 4, 4, None),
    ("optical-sim", "fft", (16, 12), 7, 4, 4, None),
    ("optical-sim", "fft", (12, 8), 6, 6, 1, None),
    ("optical-sim", "conv", (16, 12), 5, 5, 2, None),
    ("optical-sim", "conv", (8, 8), 3, 3, 4, None),  # fewer items than devices
    ("ideal", "fft", (16, 12), 4, 2, 2, None),
    ("ideal", "conv", (16, 12), 6, 4, 4, None),
    ("host", "fft", (16, 12), 7, 7, 1, 3),
    ("optical-sim", "fft", (16, 12), 7, 7, 1, 3),
    ("optical-sim", "fft", (12, 8), 5, 5, 1, 1),
    ("optical-sim", "fft", (12, 8), 5, 5, 1, 8),
    ("optical-sim", "conv", (16, 12), 6, 6, 2, 4),
    ("ideal", "conv", (12, 8), 7, 4, 2, 2),
]

# The reference's hypothesis sweep, as a fixed grid: odd shapes, more
# devices than frames, tiles of one, and the (15, 13) optical conv at
# which the reference's own batched and looped results part.
GROUP_SWEEP = [
    ("host", "conv", (5, 19), 8, 5, 4, 2),
    ("ideal", "fft", (20, 4), 1, 1, 4, None),
    ("optical-sim", "conv", (15, 13), 2, 2, 1, None),
    ("optical-sim", "conv", (9, 17), 8, 3, 4, 1),
    ("optical-sim", "fft", (19, 6), 6, 5, 2, 6),
    ("ideal", "conv", (4, 4), 3, 2, 4, None),
]


@pytest.mark.parametrize(
    "backend,category,shape,calls,max_batch,n_devices,tile_k",
    GROUP_CASES + GROUP_SWEEP)
def test_group_sharded_equivalence_fixed(backend, category, shape, calls,
                                         max_batch, n_devices, tile_k):
    check_group_equivalence(backend, category, shape, calls, max_batch,
                            n_devices, tile_k)


@pytest.mark.parametrize("backend", ["host", "optical-sim"])
@pytest.mark.parametrize("mode", ["group", "frame"])
def test_sharded_matmul_equivalence(backend, mode):
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((12, 16)).astype(np.float32) for _ in range(5)]
    w = rng.standard_normal((16, 8)).astype(np.float32)
    spec, jspec = _mvm(tacc, tconv), _mvm(jacc, jconv)
    sharded, _ = _trun(SHARDED_OF[backend], "matmul", xs, spec, max_batch=5,
                       n_devices=3, shard_mode=mode, weights=w)
    batched, _ = _trun(backend, "matmul", xs, spec, max_batch=5, weights=w)
    looped, _ = _trun(backend, "matmul", xs, spec, max_batch=1, weights=w)
    ref, _ = _jrun(SHARDED_OF[backend], "matmul", xs, jspec, max_batch=5,
                   n_devices=3, shard_mode=mode, weights=w)
    for hs, hb, hl, hr in zip(sharded, batched, looped, ref):
        if mode == "frame" and backend == "optical-sim":
            # row tiles DAC-range per tile: quantization-level differences
            assert _rel(hs.value, hb.value) < 0.05
            assert _rel(hs.value, hr.value) < 0.05
        else:
            _close(hs.value, hb.value)
            top = float(np.abs(np.asarray(hr.value)).max())
            levels = (1 << spec.adc.bits) - 1
            tol = 2.0 * top / levels if backend == "optical-sim" \
                else 1e-5 * top
            np.testing.assert_allclose(np.asarray(hs.value),
                                       np.asarray(hr.value), rtol=1e-5,
                                       atol=tol)
        _close(hb.value, hl.value)
        if backend != "host":
            assert dataclasses.asdict(hs.cost) == dataclasses.asdict(hr.cost)


# --- frame sharding (overlap-save tiling) -------------------------------------


def _frame_bound(backend, got, want):
    if backend == "optical-sim":
        # per-tile detector auto-exposure: quantization tolerance
        assert _rel(got, want) < 0.02
    else:
        _close(got, want, rtol=1e-4, atol=1e-5)


def check_frame_conv(backend, shape, calls, n_devices):
    frames = _frames(calls, shape)
    kernel = _kernel(shape)
    sharded, ex = _trun(SHARDED_OF[backend], "conv", frames,
                        max_batch=calls, n_devices=n_devices,
                        shard_mode="frame", kernel=kernel)
    unsharded, _ = _trun(backend, "conv", frames, max_batch=calls,
                         kernel=kernel)
    ref, jex = _jrun(SHARDED_OF[backend], "conv", frames, max_batch=calls,
                     n_devices=n_devices, shard_mode="frame", kernel=kernel)
    for hs, hb, hr in zip(sharded, unsharded, ref):
        _frame_bound(backend, hs.value, hb.value)
        _frame_bound(backend, hs.value, hr.value)
        if backend != "host":
            assert dataclasses.asdict(hs.cost) == dataclasses.asdict(hr.cost)
    n_eff = min(n_devices, shape[0])
    assert ex.telemetry.devices_observed("conv") == n_eff
    halo = sum(trt.kernel_halo(torch.from_numpy(kernel)))
    per_dev = ex.telemetry.device_samples("conv")
    assert per_dev == jex.telemetry.device_samples("conv")
    s_in = sum(s for s, _ in per_dev.values())
    assert s_in == calls * (shape[0] + n_eff * halo) * shape[1]


FRAME_CASES = [
    ("host", (16, 12), 2, 2),
    ("host", (17, 8), 1, 4),        # rows don't divide the device count
    ("ideal", (16, 12), 2, 3),
    ("optical-sim", (16, 12), 2, 2),
    ("optical-sim", (20, 8), 1, 4),
]

# the reference's frame-sharding hypothesis sweep, as a fixed grid
FRAME_SWEEP = [
    ("host", (6, 4), 3, 4),
    ("ideal", (23, 15), 1, 2),
    ("optical-sim", (24, 16), 3, 3),
]


@pytest.mark.parametrize("backend,shape,calls,n_devices",
                         FRAME_CASES + FRAME_SWEEP)
def test_frame_sharded_conv_fixed(backend, shape, calls, n_devices):
    check_frame_conv(backend, shape, calls, n_devices)


def test_auto_mode_frame_shards_only_oversized_frames():
    """auto: a frame bigger than one aperture tiles; a lone small frame
    stays whole; fft never frame-shards."""
    tiny = dataclasses.replace(SPEC, slm_pixels=(8, 8))
    k = _kernel((16, 12))
    (im,) = _frames(1, (16, 12))
    _, ex = _trun("sharded", "conv", [im], tiny, max_batch=8, n_devices=4,
                  shard_mode="auto", kernel=k)
    assert ex.telemetry.devices_observed("conv") == 4
    assert all(s_out == 4 * 12 for _, s_out in
               ex.telemetry.device_samples("conv").values())
    _, ex2 = _trun("sharded", "conv", [im], max_batch=8, n_devices=4,
                   shard_mode="auto", kernel=k)
    assert ex2.telemetry.devices_observed("conv") == 1
    assert all(s_in == 16 * 12 for s_in, _ in
               ex2.telemetry.device_samples("conv").values())
    _, ex3 = _trun("sharded", "fft", [im], tiny, max_batch=8, n_devices=4,
                   shard_mode="auto")
    assert ex3.telemetry.devices_observed("fft") == 1


# --- pricing: max-over-devices + sync epsilon ---------------------------------


@pytest.mark.parametrize("calls,n", [(7, 1), (7, 2), (7, 4), (3, 4)])
def test_sharded_cost_matches_spec_n_devices_pricing(calls, n):
    frames = _frames(calls, (16, 12))
    hs, _ = _trun("sharded", "fft", frames, max_batch=8, n_devices=n)
    want = SPEC.batched_step_cost(16 * 12, batch=calls, pipeline_depth=2,
                                  n_devices=n)
    assert hs[0].cost.total_s * calls == pytest.approx(want.total_s,
                                                       rel=1e-9)
    jwant = JSPEC.batched_step_cost(16 * 12, batch=calls, pipeline_depth=2,
                                    n_devices=n)
    assert dataclasses.asdict(want) == dataclasses.asdict(jwant)


@pytest.mark.parametrize("batch,n", [(8, 1), (8, 4), (3, 4), (1, 2)])
def test_batched_step_cost_n_devices_matches_reference(batch, n):
    for tspec, jspec in ((_laned(tacc), _laned(jacc)),
                         (_mvm(tacc, tconv), _mvm(jacc, jconv))):
        args = (512, 512) if isinstance(tspec, tacc.OpticalMVMAcceleratorSpec) \
            else (4096,)
        got = tspec.batched_step_cost(*args, batch=batch, pipeline_depth=2,
                                      n_devices=n)
        want = jspec.batched_step_cost(*args, batch=batch, pipeline_depth=2,
                                       n_devices=n)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(ValueError):
        _laned(tacc).batched_step_cost(4096, batch=8, n_devices=0)


def test_shard_sizes_and_halo_helpers():
    for total, n in ((7, 4), (3, 8), (8, 1), (1, 1), (5, 2), (16, 5), (9, 9)):
        assert trt.shard_sizes(total, n) == jrt.shard_sizes(total, n)
    assert trt.shard_sizes(7, 4) == [2, 2, 2, 1]
    k = np.zeros((16, 8), np.float32)
    k[0, 0], k[2, 1] = 1.0, 0.5
    k_wrap = k.copy()
    k_wrap[15, 0] = 0.25
    for arr, want in ((k, (2, 0)), (k_wrap, (2, 1)),
                      (np.zeros((8, 8), np.float32), (0, 0)),
                      (_kernel((16, 12)), None)):
        got = trt.kernel_halo(torch.from_numpy(arr))
        assert got == jrt.kernel_halo(jnp.asarray(arr))
        assert want is None or got == want


def test_halo_and_fold_are_cached_by_kernel_content():
    """A repeat frame-sharded flush reads nothing of the kernel back: the
    halo and the folded tiles come from caches keyed by its content."""
    frames = _frames(1, (16, 12))
    k = _kernel((16, 12))
    ex = trt.OffloadExecutor(SPEC, max_batch=1, n_devices=4,
                             default_backend="sharded-host",
                             shard_mode="frame", device="cpu")
    kt = torch.from_numpy(k)
    for _ in range(2):
        ex.run("conv", torch.from_numpy(frames[0]), kernel=kt)
    be = ex._backend("sharded-host")
    assert len(be._halo_cache) == 1
    assert len(be._fold_cache) == 1      # 4 tiles of 4 rows + halo (2, 1)
    calls = []
    orig = tsharded.kernel_halo
    try:
        tsharded.kernel_halo = lambda *a: calls.append(a) or orig(*a)
        ex.run("conv", torch.from_numpy(frames[0]), kernel=kt)
    finally:
        tsharded.kernel_halo = orig
    assert calls == []


def test_shard_devices_sequential_fallback_and_cards(monkeypatch):
    cpu = torch.device("cpu")
    assert tsharding.shard_devices(1, cpu) is None
    assert tsharding.shard_devices(4, cpu) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cuda = torch.device("cuda", 0)
    assert tsharding.shard_devices(4, cuda) == \
        [torch.device("cuda", i) for i in range(4)]
    assert tsharding.shard_devices(5, cuda) is None
    assert tsharding.shard_devices(4, cpu) is None
    assert tsharding.shard_devices(1, cuda) is None


def test_sharded_backend_registry_and_supports():
    be = trt.get_backend("sharded")
    assert isinstance(be, trt.ShardedOpticalBackend)
    assert be.name == "sharded" and be.inner_name == "optical-sim"
    assert trt.get_backend("sharded-host").name == "sharded-host"
    assert trt.get_backend("sharded-ideal").inner_name == "ideal"
    ex = trt.OffloadExecutor(SPEC, n_devices=2, default_backend="sharded",
                             device="cpu")
    with pytest.raises(ValueError):  # Fourier spec cannot serve matmul
        ex.submit("matmul", torch.ones(8, 8), weights=torch.ones(8, 8))
    with pytest.raises(ValueError):
        trt.OffloadExecutor(SPEC, n_devices=0, device="cpu")
    with pytest.raises(ValueError):
        trt.OffloadExecutor(SPEC, shard_mode="diagonal", device="cpu")


def _spy_inner(be, seen, depths=None):
    inner = be.inner
    orig = inner.run

    def spy(category, xs, ctx, **kw):
        seen.append((len(xs),) + tuple(xs[0].shape))
        if depths is not None:
            depths.append(ctx.pipeline_depth)
        return orig(category, xs, ctx, **kw)

    inner.run = spy
    return lambda: setattr(inner, "run", orig)


def test_warm_primes_sharded_dispatch_shapes():
    ex = trt.OffloadExecutor(SPEC, max_batch=6, n_devices=4,
                             default_backend="sharded", device="cpu")
    ex.set_n_devices("fft", 3)
    seen: list[tuple] = []
    undo = _spy_inner(ex._backend("sharded"), seen)
    try:
        frames = [torch.from_numpy(x) for x in _frames(6, (16, 12))]
        ex.warm("fft", frames[0], batch=6)
        warmed, seen[:] = set(seen), []
        assert not ex.telemetry.stats
        assert ex.ctx.n_devices == 4          # restored after warm
        for h in [ex.submit("fft", x) for x in frames]:
            h.get()
        flushed = set(seen)
    finally:
        undo()
    assert flushed <= warmed, (flushed, warmed)
    assert (2, 16, 12) in warmed


def test_warm_primes_per_engine_window_and_placed_shapes():
    ex = trt.OffloadExecutor(SPEC, max_batch=6, n_devices=3,
                             default_backend="sharded-host", residency=True,
                             device="cpu")
    ex.set_pipeline_window("fft", 3)
    seen: list[tuple] = []
    depths: list[int] = []
    undo = _spy_inner(ex._backend("sharded-host"), seen, depths)
    try:
        frames = [torch.from_numpy(x) for x in _frames(6, (16, 12))]
        saved_depth = ex.ctx.pipeline_depth
        ex.warm("fft", frames[0], batch=6)
        assert depths and all(d == 3 for d in depths)
        assert ex.ctx.pipeline_depth == saved_depth
        assert ex.ctx.watchdog is ex._watchdog   # restored after warm
        warmed, seen[:] = set(seen), []
        for h in [ex.submit("fft", x) for x in frames]:
            h.get()
        flushed = set(seen)
    finally:
        undo()
    assert flushed <= warmed, (flushed, warmed)
    assert ex.ctx.pipeline_depth == 3


# --- telemetry: per-device aggregation ----------------------------------------


def test_telemetry_aggregates_and_merges_per_device_samples():
    outs = []
    for rt in (jrt, trt):
        t = rt.RuntimeTelemetry()
        t.record("fft", "sharded", calls=4, samples_in=400, samples_out=400,
                 wall_s=0.01, per_device=[(200, 200), (200, 200)])
        t.record("fft", "sharded", calls=2, samples_in=200, samples_out=200,
                 wall_s=0.01, per_device=[(100, 100), (100, 100)])
        assert t.device_samples("fft") == {0: (300, 300), 1: (300, 300)}
        assert t.devices_observed("fft") == 2
        assert t.devices_observed("conv") == 1
        other = rt.RuntimeTelemetry()
        other.record("fft", "sharded", calls=1, samples_in=50,
                     samples_out=50, wall_s=0.001,
                     per_device=[(25, 25), (20, 20), (5, 5)])
        t.merge(other)
        assert t.devices_observed("fft") == 3
        assert t.device_samples("fft")[2] == (5, 5)
        assert "devices[3]" in t.summary()
        outs.append(t.device_samples("fft"))
        t.reset()
        assert t.device_samples("fft") == {} and t.devices_observed() == 1
    assert outs[0] == outs[1]


def test_executor_feeds_per_device_samples_to_telemetry():
    frames = _frames(6, (16, 12))
    _, ex = _trun("sharded", "fft", frames, max_batch=6, n_devices=4)
    st = ex.telemetry.stats[("fft", "sharded")]
    assert ex.telemetry.device_samples("fft") == \
        {0: (384, 384), 1: (384, 384), 2: (192, 192), 3: (192, 192)}
    assert st.samples_in == 6 * 16 * 12


def test_sharded_host_wall_counts_as_host_time():
    t = trt.RuntimeTelemetry()
    t.record("fft", "sharded-host", calls=4, samples_in=40, samples_out=40,
             wall_s=0.04)
    assert t.host_timed("fft")
    (prof,) = t.profiles(include_other=False)
    assert prof.host_s == pytest.approx(0.04)


# --- PlanRouter: devices chosen alongside max_batch ---------------------------


def _routed_executor(n_devices=4, max_batch=16):
    ex = trt.OffloadExecutor(SPEC, default_backend="host",
                             max_batch=max_batch, n_devices=n_devices,
                             device="cpu")
    router = trt.PlanRouter(ex, offload_backend="sharded")
    for im in _frames(8, (16, 16)):
        router.run("fft", torch.from_numpy(im))
    return ex, router


def check_replan_sharding(batch_cap, dev_cap, deadlines):
    ex, router = _routed_executor()
    if batch_cap is not None:
        ex.set_max_batch("fft", batch_cap)
    if dev_cap is not None:
        ex.set_n_devices("fft", dev_cap)
    prev_k = prev_n = None
    for deadline in [None] + sorted(deadlines, reverse=True):
        k, n, t = router.choose_sharding(deadline_s=deadline)["fft"]
        assert 1 <= k <= min(16, batch_cap or 16)
        assert 1 <= n <= min(4, dev_cap or 4, k)
        assert 1 <= t <= k
        if prev_k is not None:
            assert k <= prev_k and n <= prev_n
        prev_k, prev_n = k, n
        router.replan(deadline_s=deadline)
        assert ex.max_batch_for("fft") == k
        assert ex.n_devices_for("fft") == n
        assert ex.category_tile_ks()["fft"] == t


REPLAN_CASES = [
    (None, None, [1e-1, 1e-2, 1e-3, 1e-4]),
    (8, 2, [5e-2, 5e-3, 5e-4]),
    (4, None, [1e-2, 1e-3]),
    (None, 1, [1e-2, 2e-4]),
    # the reference's hypothesis sweep, as fixed cases
    (1, 4, [1.0, 1e-5]),
    (16, 3, [3e-3, 3e-3, 7e-2]),
]


@pytest.mark.parametrize("batch_cap,dev_cap,deadlines", REPLAN_CASES)
def test_replan_sharding_fixed(batch_cap, dev_cap, deadlines):
    check_replan_sharding(batch_cap, dev_cap, deadlines)


def _synthetic(ex):
    """Identical recorded host traffic in either package."""
    n = 16 * 16
    ex.telemetry.record("fft", "host", calls=12, samples_in=12 * n,
                        samples_out=12 * n, wall_s=0.03)
    ex.telemetry.record("fft", "host", calls=4, samples_in=4 * n,
                        samples_out=4 * n, wall_s=0.01)


@pytest.mark.parametrize("dev_cap", [None, 2])
@pytest.mark.parametrize("deadline_s", [None, 1e-2, 1e-4])
def test_choose_sharding_matches_reference(dev_cap, deadline_s):
    got = []
    for rt, spec, kw in ((jrt, JSPEC, {}), (trt, SPEC, {"device": "cpu"})):
        ex = rt.OffloadExecutor(spec, default_backend="host", max_batch=16,
                                n_devices=4,
                                mem_budget=rt.MemoryBudget(1 << 20), **kw)
        if dev_cap is not None:
            ex.set_n_devices("fft", dev_cap)
        _synthetic(ex)
        router = rt.PlanRouter(ex, offload_backend="sharded")
        got.append(router.choose_sharding(deadline_s=deadline_s))
    assert got[0] == got[1]


def test_replan_restores_operator_device_bound_after_deadline():
    ex, router = _routed_executor(n_devices=4, max_batch=16)
    ex.set_n_devices("fft", 2)
    router.replan()
    assert ex.n_devices_for("fft") == 2
    router.replan(deadline_s=1e-9)
    assert ex.max_batch_for("fft") == 1
    assert ex.n_devices_for("fft") == 1
    router.replan()
    assert ex.n_devices_for("fft") == 2
    assert ex.max_batch_for("fft") == 16


# --- the placed route: four device handles ------------------------------------


@pytest.fixture
def four_devices(monkeypatch):
    """``shard_devices`` handing out four CPU handles: the placed route
    (copies, per-device residency, placements, gathers) runs as it runs
    across four cards, which the reference exercises with forced XLA host
    devices in a subprocess."""
    calls = []

    def fake(n, home):
        calls.append(n)
        return None if n <= 1 or n > 4 else [torch.device("cpu")] * n

    monkeypatch.setattr(tsharded, "shard_devices", fake)
    return calls


def test_placement_not_committed_without_residency_or_off_mesh():
    frames = [torch.from_numpy(x) for x in _frames(6, (16, 12))]
    ex = trt.OffloadExecutor(SPEC, max_batch=6, n_devices=3,
                             default_backend="sharded-host", device="cpu")
    for h in [ex.submit("fft", x) for x in frames]:
        h.get()
    assert not ex._backend("sharded-host")._placements
    ex_r = trt.OffloadExecutor(SPEC, max_batch=6, n_devices=3,
                               default_backend="sharded-host", residency=True,
                               device="cpu")
    for h in [ex_r.submit("fft", x) for x in frames]:
        h.get()
    assert tsharding.shard_devices(3, ex_r.device) is None
    assert not ex_r._backend("sharded-host")._placements


def test_sharded_dispatch_scatters_across_device_handles(four_devices):
    """Group AND frame sharding over digital and optical inners through
    the placed route's copies and gathers, against the single-device
    path (the reference's forced-device script)."""
    frames = _frames(8, (16, 12))
    kern = _kernel((16, 12))
    hs, ex = _trun("sharded-host", "fft", frames, max_batch=8, n_devices=4)
    ss, _ = _trun("host", "fft", frames, max_batch=8)
    for a, b in zip(hs, ss):
        _close(a.value, b.value, atol=1e-6)
    assert len(ex.telemetry.device_samples("fft")) == 4
    ho, exo = _trun("sharded", "conv", frames, max_batch=8, n_devices=4,
                    kernel=kern)
    so, _ = _trun("optical-sim", "conv", frames, max_batch=8, kernel=kern)
    for a, b in zip(ho, so):
        _close(a.value, b.value)
    assert len(exo.telemetry.device_samples("conv")) == 4
    for backend, single in (("sharded-host", "host"),
                            ("sharded", "optical-sim")):
        hf, _ = _trun(backend, "conv", frames[:1], max_batch=8, n_devices=4,
                      shard_mode="frame", kernel=kern)
        sf, _ = _trun(single, "conv", frames[:1], max_batch=8, kernel=kern)
        if backend == "sharded-host":
            _close(hf[0].value, sf[0].value, rtol=1e-4, atol=1e-5)
        else:
            assert _rel(hf[0].value, sf[0].value) < 0.05
    assert 4 in four_devices


def test_placement_lifecycle_on_device_handles(four_devices):
    """Commit -> repeat-flush hits -> tiled re-commit -> device-loss drop ->
    survivor rebuild, bit-equal to the looped host baseline throughout
    (the reference's forced-device placement script)."""
    k = 16
    imgs = [torch.from_numpy(x) for x in _frames(k, (16, 12), seed=3)]
    base = trt.OffloadExecutor(max_batch=1, default_backend="host",
                               device="cpu")
    want = [h.value for h in
            ([base.submit("fft", im) for im in imgs], base.flush())[0]]

    def flush(ex):
        hs = [ex.submit("fft", im) for im in imgs]
        ex.flush()
        for h, w in zip(hs, want):
            torch.testing.assert_close(h.value, w, rtol=0, atol=0)

    ex = trt.OffloadExecutor(max_batch=k, n_devices=4,
                             default_backend="sharded-host", residency=True,
                             device="cpu")
    ex.warm("fft", imgs[0], batch=k)
    flush(ex)
    be = ex._backend("sharded-host")
    (pl,) = be._placements.values()
    assert pl.pool == [0, 1, 2, 3] and pl.frames == k
    flush(ex)
    assert ex.telemetry.residency_counts["fft"].get("hit", 0) >= k
    ex.set_tile_k("fft", 5)
    flush(ex)
    assert be._placements, "a tiled flush re-commits the placement"
    ex.set_tile_k("fft", k)
    ex.ctx.lost_devices = frozenset({1})
    flush(ex)
    ex.ctx.lost_devices = frozenset()
    assert ex.quarantine.is_quarantined(("device", 1), ex.now())
    assert not be._placements, "the fault drops the placement"
    flush(ex)
    (pl2,) = be._placements.values()
    assert pl2.pool == [0, 2, 3]


def test_mixed_device_caches_are_keyed_by_device():
    """A shard on another card gets its own DFT factors, Fourier mask and
    operands there; a cached stack on one device is never served to a
    group on another."""
    ctx = trt.OffloadExecutor(SPEC, device="cpu").ctx
    home = ctx.factors(16, (1, 2))
    assert ctx.factors(16, (1, 2), torch.device("cpu")) is home
    meta = torch.device("meta")
    other = ctx.factors(16, (1, 2), meta)
    assert other[0].device == meta and (16, 1, 2, "meta") in ctx.factor_cache
    be = trt.ShardedOpticalBackend("host")
    k = torch.from_numpy(_kernel((8, 8)))
    assert be._local(k, torch.device("cpu"), ctx) is k
    assert be._local(k, meta, ctx).device == meta
    assert be._local(k, meta, ctx) is be._local(k, meta, ctx)
