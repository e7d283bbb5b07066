"""The port's CUDA kernels, its executor and its LM stack on the card.

Every test here needs a CUDA card and skips without one (the decision is
made inside each test, through the ``cuda_device`` fixture).  The file
imports ``torch``, numpy and ``repro_torch`` only, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Bounds are the reference's (``tests/test_kernels.py``): stage 1 rtol 1e-4
/ atol 1e-5, stage 2 rtol 1e-4 / atol 1e-4*max, each kernel against its
plain PyTorch version on the same card with TF32 off.  Shapes whose k and
n are multiples of 4, with 16-byte aligned operands, take the DFT
kernels' tensor-core route (3xTF32 on ``wgmma``, the contraction split
across a cluster), the others their FMA route; each test asserts the
route's launch counter, and the same bounds hold on both.  On the
tensor-core route a frame's result is bit-equal alone, in a batch of 16
and on a repeat.  The executor's
``optical-sim`` frames are held to the ``host`` backend within 2e-4*max
plus one 14-bit ADC step of the frame's full scale.  The flash-attention
kernel is held to its plain version at rtol/atol 2e-5 in float32, the
reference's bound (``tests/test_kernels.py``), and at rtol 1e-2 / atol
1e-3 in bfloat16: both sides compute in fp32 from the same inputs, so they
differ by at most one bf16 rounding of the output (2^-7 relative).
bf16 at head dims 64, 128, 192 and 256 takes the kernel's tensor-core
route (``wgmma`` forward, ``mma.sync`` backward, P and dS split into two
bf16 terms), everything else (float32, float16 and bf16 at any other head
dim, past 256 in chunks of 256 columns) its FMA route; each test asserts the route's launch
counter, and the same bounds hold on both (float16 at rtol 2e-3, one
rounding of its 11-bit output).  A misaligned operand of the
tensor-core route is copied once and counted in ``realigned``.
An LM prefill on the card goes through it once per attention layer and
matches the same model's prefill on the CPU at the bf16 decode bound of
``tests/test_models.py`` (5e-2), the recurrent families and the MoE ones
(MLA's V narrower than q and k: padded on the card) included; the MoE
layer's combine gives the same bits on every call.

The attention backward is held to its plain version's autograd on the
same inputs at 1e-4 * max|plain| in float32 (summation order only) and
2e-2 * max|plain| in bfloat16 (the kernel takes the row sums dO . O from
the bf16-rounded output, as flash-attention backwards do), and must give
bit-equal gradients when launched twice.  The converter-boundary kernel
is held to its plain version bit for bit (NaN where it has NaN) on both
of its routes: both compute the same IEEE operations in the same order.  A smoke-config training loss and its
gradients on the card match the CPU's at the bf16 bound (5e-2).

The sharded offload backend's group-sharded fft flush equals the
unsharded one bit for bit (a DFT frame has the same bits alone or in any
batch, and the ADC ranges per frame), on one card (shards in turn) and,
run with four cards, across them; its frame-sharded conv meets the
reference's host bound (rtol 1e-4, atol 1e-5); a seeded chaos run
retires every frame.

The case study: ``OpProfiler`` waits for the card at a bracket's edges, so
work queued before a bracket is charged to 'other', not to the bracket;
``flops_by_category`` of a smoke LM loss is the same on the card (its
attention through kernel 6) as on the CPU; three benchmarks of the Amdahl
suite bracket on the card what the reference brackets, and their first
bracketed output is held to the CPU's on the same inputs within the CPU
test's replay bound (1e-4 * max).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch import runtime as trt
from repro_torch.kernels import adc_dac
from repro_torch.kernels import local_attention as la
from repro_torch.kernels import ops
from repro_torch.kernels import optical_dft as od
from repro_torch.casestudy import amdahl_suite
from repro_torch.core.profiler import OpProfiler, flops_by_category
from repro_torch.launch import train as ttrain
from repro_torch.models import LM, compute_params, init_params
from repro_torch.models.params import leaves, map_tree
from repro_torch.optim import adafactor, ef_compress, ef_init
from repro_torch.serving import Request, ServingEngine
from repro_torch.train import loss_and_grads

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, shape, dev):
    a = np.random.default_rng(seed).random(shape, dtype=np.float32)
    return torch.from_numpy(a).to(dev)


def _rows(k, m, dev):
    """W (m, k): the unitary factors of size k, rows repeated to m."""
    wr, wi = od.dft_matrix_factors(k, device=dev)
    reps = -(-m // k)
    return (wr.repeat(reps, 1)[:m].contiguous(),
            wi.repeat(reps, 1)[:m].contiguous())


@pytest.mark.parametrize("batch,m,k,n", [(2, 512, 512, 512), (5, 64, 64, 64),
                                         (1, 8, 256, 128), (3, 128, 128, 256),
                                         (1, 512, 512, 512),
                                         (16, 512, 512, 512)])
def test_kernels_match_plain_versions(cuda_device, batch, m, k, n):
    wr, wi = _rows(k, m, cuda_device)
    a = _rand(20, (batch, k, n), cuda_device)
    od.reset_launches()
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=8)
    pr, pi = od.dft_stage1_batched_plain(wr, wi, a, dac_bits=8)
    assert od.dft_stage1_batched.launches == 1
    assert od.dft_stage1_batched.launches_by_route["tensor_core"] == 1
    torch.testing.assert_close(tr, pr, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ti, pi, rtol=1e-4, atol=1e-5)
    w2r, w2i = _rows(n, n, cuda_device)
    got = od.dft_stage2_batched(tr, ti, w2r, w2i)
    want = od.dft_stage2_batched_plain(tr, ti, w2r, w2i)
    assert od.dft_stage2_batched.launches == 1
    assert od.dft_stage2_batched.launches_by_route["tensor_core"] == 1
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.max()))


@pytest.mark.parametrize("value,bits", [(0.5, 8), (0.4960784316062927, 8),
                                        (0.5, 1)])
def test_dac_rounds_ties_to_even(cuda_device, value, bits):
    wr, wi = od.dft_matrix_factors(64, device=cuda_device)
    a = torch.full((1, 64, 64), value, device=cuda_device)
    od.reset_launches()
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=bits)
    pr, pi = od.dft_stage1_batched_plain(wr, wi, a, dac_bits=bits)
    assert od.dft_stage1_batched.launches_by_route == {"tensor_core": 1,
                                                       "fma": 0}
    torch.testing.assert_close(tr, pr, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ti, pi, rtol=1e-4, atol=1e-5)


def test_tensor_core_frames_are_bit_equal_alone_and_on_repeat(cuda_device):
    """The tile and the split come from (m, k, n) alone and no sum uses
    atomics: frame i of a batch of 16 is the single-frame call's bits."""
    wr, wi = od.dft_matrix_factors(512, device=cuda_device)
    a = _rand(22, (16, 512, 512), cuda_device)
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=8)
    out = od.dft_stage2_batched(tr, ti, wr, wi)
    for i in range(16):
        tr1, ti1 = od.dft_stage1(wr, wi, a[i], dac_bits=8)
        assert torch.equal(tr1, tr[i]) and torch.equal(ti1, ti[i])
        assert torch.equal(od.dft_stage2(tr[i], ti[i], wr, wi), out[i])
    tr2, ti2 = od.dft_stage1_batched(wr, wi, a, dac_bits=8)
    assert torch.equal(tr2, tr) and torch.equal(ti2, ti)
    assert torch.equal(od.dft_stage2_batched(tr, ti, wr, wi), out)


def _misaligned(t):
    """t's values in a contiguous tensor whose data is 4 bytes past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("case", ["ragged n", "ragged k", "misaligned A",
                                  "misaligned T", "24-bit DAC"])
def test_fma_route_takes_what_the_tensor_cores_do_not(cuda_device, case):
    """k or n not a multiple of 4, an operand off 16 bytes, or a DAC of
    24 bits or more (2^24 - 1 levels, past the exact range of the
    tensor-core route's quotient) takes the FMA route and meets the same
    bounds."""
    batch, m, k, n = {"ragged n": (2, 100, 96, 130),
                      "ragged k": (2, 64, 66, 64)}.get(case, (2, 128, 128,
                                                                128))
    # stage 2 contracts over stage 1's n, and reads T
    routes = {"ragged n": ("fma", "fma"), "ragged k": ("fma", "tensor_core"),
              "misaligned A": ("fma", "tensor_core"),
              "misaligned T": ("tensor_core", "fma"),
              "24-bit DAC": ("fma", "tensor_core")}[case]
    dac_bits = 24 if case == "24-bit DAC" else 8
    wr, wi = _rows(k, m, cuda_device)
    a = _rand(23, (batch, k, n), cuda_device)
    if case == "misaligned A":
        a = _misaligned(a)
    od.reset_launches()
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=dac_bits)
    pr, pi = od.dft_stage1_batched_plain(wr, wi, a, dac_bits=dac_bits)
    assert od.dft_stage1_batched.launches_by_route[routes[0]] == 1
    torch.testing.assert_close(tr, pr, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ti, pi, rtol=1e-4, atol=1e-5)
    if case == "misaligned T":
        tr = _misaligned(tr)
    w2r, w2i = _rows(n, n, cuda_device)
    got = od.dft_stage2_batched(tr, ti, w2r, w2i)
    want = od.dft_stage2_batched_plain(tr, ti, w2r, w2i)
    assert od.dft_stage2_batched.launches_by_route[routes[1]] == 1
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.max()))


@pytest.mark.parametrize("case", ["nan", "+inf", "-inf", "all negative"])
@pytest.mark.parametrize("route", od.ROUTES)
def test_dft_kernels_keep_nan_and_clip_inf(cuda_device, case, route):
    """The DAC of both routes keeps NaN and clips infinities as the plain
    version (and the reference) does: a NaN pixel makes its column of T
    NaN and the whole frame's intensity NaN.  Elsewhere the usual
    bounds."""
    batch, m, k, n = 2, 128, 128, 128 if route == "tensor_core" else 130
    wr, wi = _rows(k, m, cuda_device)
    a = _rand(24, (batch, k, n), cuda_device) * 1.2 - 0.1
    if case == "all negative":
        a = -a - 0.2
    else:
        a[0, ::9, 5::11] = {"nan": float("nan"), "+inf": float("inf"),
                            "-inf": float("-inf")}[case]
    od.reset_launches()
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=8)
    pr, pi = od.dft_stage1_batched_plain(wr, wi, a, dac_bits=8)
    assert od.dft_stage1_batched.launches_by_route[route] == 1
    for got, want in ((tr, pr), (ti, pi)):
        assert torch.equal(got.isnan(), want.isnan())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5,
                                   equal_nan=True)
    w2r, w2i = _rows(n, n, cuda_device)
    got = od.dft_stage2_batched(tr, ti, w2r, w2i)
    want = od.dft_stage2_batched_plain(pr, pi, w2r, w2i)
    assert torch.equal(got.isnan(), want.isnan())
    assert bool(got[0].isnan().all()) == (case == "nan")
    assert not bool(got[1].isnan().any())
    torch.testing.assert_close(got, want, rtol=1e-4, equal_nan=True,
                               atol=1e-4 * float(want[1].max()))


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    wr, wi = od.dft_matrix_factors(64, device=cuda_device)
    a = _rand(21, (2, 64, 64), cuda_device)
    with pytest.raises(TypeError):
        od.dft_stage1_batched(wr, wi, a.double())
    with pytest.raises(ValueError):
        od.dft_stage1_batched(wr, wi, a.transpose(1, 2))    # not contiguous
    with pytest.raises(ValueError):
        od.dft_stage1_batched(wr.cpu(), wi.cpu(), a)         # mixed devices


def test_executor_launches_kernels_and_matches_host(cuda_device):
    ex = trt.OffloadExecutor(trt.BATCHED_4F, max_batch=8)
    assert ex.device.type == "cuda" and ex.mem_budget.source == "l2"
    imgs = [_rand(30 + i, (128, 128), cuda_device) for i in range(8)]
    od.reset_launches()
    hs = [ex.submit("fft", im) for im in imgs]
    ex.flush_async()
    refs = [ex.submit("fft", im, backend="host") for im in imgs]
    ex.flush()
    assert od.dft_stage1_batched.launches >= 1
    assert od.dft_stage2_batched.launches >= 1
    levels = (1 << trt.BATCHED_4F.adc.bits) - 1
    for h, r in zip(hs, refs):
        assert h.done() and h.value.is_cuda
        top = float(r.value.max())
        err = float((h.value - r.value).abs().max())
        assert err <= 2e-4 * top + float(h.value.max()) / levels


@pytest.mark.parametrize("n_devices,tile_k,shape", [
    (4, None, (128, 128)), (4, 1, (128, 128)), (3, 5, (96, 64)),
    (2, 8, (256, 256))])
def test_sharded_fft_flush_is_bit_equal_to_unsharded(cuda_device, n_devices,
                                                     tile_k, shape):
    """Group sharding changes only how a flush's frames are grouped: each
    frame's DFT has the same bits alone or in any batch on the
    tensor-core route, and the ADC ranges per frame, so the sharded flush
    equals the unsharded one bit for bit."""
    imgs = [_rand(60 + i, shape, cuda_device) for i in range(8)]
    outs = {}
    for n, backend in ((1, "optical-sim"), (n_devices, "sharded")):
        ex = trt.OffloadExecutor(trt.BATCHED_4F, max_batch=8, n_devices=n,
                                 default_backend=backend, tile_k=tile_k)
        od.reset_launches()
        hs = [ex.submit("fft", im) for im in imgs]
        ex.flush()
        for stage in (od.dft_stage1_batched, od.dft_stage2_batched):
            assert stage.launches >= 1
            assert stage.launches_by_route["fma"] == 0
        outs[backend] = [h.value for h in hs]
        assert all(h.backend == backend for h in hs)
    for a, b in zip(outs["sharded"], outs["optical-sim"]):
        assert a.device == b.device == imgs[0].device
        assert torch.equal(a, b)


def test_sharded_placed_route_on_the_card(cuda_device, monkeypatch):
    """The placed route (copies to each shard's card, per-device
    residency, placements, the gather) with every logical device handed
    the same card: bit-equal to the unsharded flush, placement committed
    and served from residency on the repeat flush."""
    from repro_torch.runtime import sharded as tsharded
    monkeypatch.setattr(tsharded, "shard_devices",
                        lambda n, home: None if n <= 1 else [home] * n)
    imgs = [_rand(70 + i, (64, 64), cuda_device) for i in range(8)]
    ref = trt.OffloadExecutor(trt.BATCHED_4F, max_batch=8)
    want = [h.value for h in ([ref.submit("fft", im) for im in imgs],
                              ref.flush())[0]]
    ex = trt.OffloadExecutor(trt.BATCHED_4F, max_batch=8, n_devices=4,
                             default_backend="sharded", residency=True)
    for _ in range(2):
        hs = [ex.submit("fft", im) for im in imgs]
        ex.flush()
        for h, w in zip(hs, want):
            assert torch.equal(h.value, w)
    assert ex._backend("sharded")._placements
    assert ex.telemetry.residency_counts["fft"].get("hit", 0) >= 8


def test_sharded_frame_conv_on_the_card(cuda_device):
    """One frame tiled over four devices by overlap-save: the host inner
    at the reference's frame-sharding bound (rtol 1e-4, atol 1e-5)."""
    frame = _rand(80, (300, 160), cuda_device)
    k = torch.zeros(300, 160, device=cuda_device)
    k[0, 0], k[1, 2], k[299, 1], k[2, 0] = 0.5, 0.25, 0.15, 0.1
    ex = trt.OffloadExecutor(trt.BATCHED_4F, max_batch=1, n_devices=4,
                             default_backend="sharded-host",
                             shard_mode="frame")
    got = ex.run("conv", frame, kernel=k)
    want = ex.run("conv", frame, kernel=k, backend="host")
    assert len(ex.telemetry.device_samples("conv")) == 4
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_chaos_sharded_run_retires_every_frame(cuda_device):
    """A seeded chaos run over the sharded backend under a ManualClock:
    every frame retires, chaos-served frames bit-equal to the unfaulted
    flush, host-served ones to the host backend."""
    imgs = [_rand(90 + i, (64, 64), cuda_device) for i in range(16)]
    ref = trt.OffloadExecutor(trt.BATCHED_4F, max_batch=16, tile_k=2)
    want = [h.value for h in ([ref.submit("fft", im) for im in imgs],
                              ref.flush())[0]]
    host = [h.value for h in ([ref.submit("fft", im, backend="host")
                               for im in imgs], ref.flush())[0]]
    name = trt.register_chaos("sharded", name="chaos-card", rate=0.3,
                              seed=0)
    clk = trt.ManualClock()
    ex = trt.OffloadExecutor(trt.BATCHED_4F, default_backend=name,
                             max_batch=16, n_devices=4, tile_k=2, clock=clk,
                             fidelity=trt.FidelityChecker())
    for _ in range(6):
        hs = [ex.submit("fft", im) for im in imgs]
        ex.flush()
        for h, w, r in zip(hs, want, host):
            assert h.ready and h.value is not None
            torch.testing.assert_close(h.value, w if h.backend == name
                                       else r, rtol=0,
                                       atol=0 if h.backend == name
                                       else 1e-5 * float(r.max()))
        clk.advance(1.0)
    counts = ex.telemetry.fault_counts["fft"]
    assert counts["device_loss"] and counts["straggle"] and counts["drift"]


def _attn_inputs(seed, bh, lq, lk, d, groups, dtype, dev):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=dev, dtype=dtype)
        for shape in ((bh, lq, d), (bh // groups, lk, d),
                      (bh // groups, lk, d)))


@pytest.mark.parametrize("lq,lk,d,groups", [
    (128, 128, 64, 1), (256, 128, 32, 2), (128, 256, 64, 4),
    (77, 77, 64, 1), (200, 200, 16, 2), (1000, 1000, 64, 1),
    (130, 70, 128, 2), (5, 300, 8, 8)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0), (False, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(cuda_device, lq, lk, d, groups,
                                               causal, window, dtype):
    q, k, v = _attn_inputs(40, 8, lq, lk, d, groups, dtype, cuda_device)
    la.reset_launches()
    got = la.local_flash_attention(q, k, v, causal=causal, window=window,
                                   kv_groups=groups)
    want = la.local_flash_attention_plain(q, k, v, causal=causal,
                                          window=window, kv_groups=groups)
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches == 1 and got.dtype == dtype
    assert la.local_flash_attention.launches_by_route[la.route(dtype, d)] == 1
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (1e-2, 1e-3)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# The tensor-core route's edges: bf16 at D 64 and 128, L of 77, 1000, 1023
# and 1024 (ragged and whole 64- and 128-row tiles), Lq != Lk, GQA groups
# 1, 4 and 8, a window of 64 and non-causal.
@pytest.mark.parametrize("lq,lk,groups", [
    (77, 77, 1), (1000, 1000, 4), (1023, 1023, 8), (1024, 1024, 1),
    (1024, 77, 4), (77, 1023, 8), (1000, 1024, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0), (False, 64)])
@pytest.mark.parametrize("d", [64, 128])
def test_tensor_core_route_matches_plain_version(cuda_device, lq, lk,
                                                 groups, causal, window, d):
    q, k, v = _attn_inputs(45, 8, lq, lk, d, groups, torch.bfloat16,
                           cuda_device)
    la.reset_launches()
    got = la.local_flash_attention(q, k, v, causal=causal, window=window,
                                   kv_groups=groups)
    want = la.local_flash_attention_plain(q, k, v, causal=causal,
                                          window=window, kv_groups=groups)
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches_by_route == {
        "tensor_core": 1, "fma": 0}
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 8, "fma"), (torch.bfloat16, 16, "fma"),
    (torch.bfloat16, 32, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 32, "fma")])
def test_each_route_counts_its_launches(cuda_device, dtype, d, route):
    """Forward and backward each count one launch on the route the dtype
    and head dim pick, and none on the other."""
    q, k, v = _attn_inputs(46, 4, 130, 130, d, 2, dtype, cuda_device)
    la.reset_launches()
    q.requires_grad_()
    la.local_flash_attention(q, k, v, kv_groups=2).float().sum().backward()
    torch.cuda.synchronize()
    other = {"tensor_core": "fma", "fma": "tensor_core"}[route]
    by_route = la.local_flash_attention.launches_by_route
    bwd_by_route = la.local_flash_attention.backward_launches_by_route
    assert (by_route[route], by_route[other]) == (1, 0)
    assert (bwd_by_route[route], bwd_by_route[other]) == (1, 0)
    assert la.local_flash_attention.launches == 1
    assert la.local_flash_attention.backward_launches == 1
    key = la.shape_key(4, 2, 130, 130, d, True, 0)
    assert la.local_flash_attention.launches_by_shape == {key: 1}
    assert la.local_flash_attention.backward_launches_by_shape == {key: 1}


def test_gqa_wrapper_launches_the_kernel(cuda_device):
    q = torch.randn(2, 8, 517, 64, device=cuda_device, dtype=torch.bfloat16)
    k = torch.randn(2, 2, 517, 64, device=cuda_device, dtype=torch.bfloat16)
    v = torch.randn_like(k)
    la.reset_launches()
    got = ops.gqa_flash_attention(q, k, v)
    want = la.local_flash_attention_plain(
        q.reshape(16, 517, 64), k.reshape(4, 517, 64), v.reshape(4, 517, 64),
        kv_groups=4).reshape(2, 8, 517, 64)
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches == 1
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3)


def test_flash_attention_raises_on_what_the_kernel_does_not_take(
        cuda_device):
    """Head dim 48 and float16 are taken (and held to the plain version),
    and so is a head dim past 256 (on the FMA route); a strided operand
    and mixed devices raise."""
    q, k, v = _attn_inputs(41, 4, 64, 64, 64, 1, torch.float32, cuda_device)
    la.reset_launches()
    for got, want in (
            (la.local_flash_attention(q.half(), k.half(), v.half()),
             la.local_flash_attention_plain(q.half(), k.half(), v.half())),
            (la.local_flash_attention(*(t[..., :48].contiguous()
                                        for t in (q, k, v))),
             la.local_flash_attention_plain(*(t[..., :48]
                                              for t in (q, k, v))))):
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2e-3 if got.dtype == torch.float16
                                   else 2e-5, atol=2e-5)
    assert la.local_flash_attention.launches_by_route == {
        "tensor_core": 0, "fma": 2}
    wide = _attn_inputs(41, 4, 64, 64, 264, 1, torch.bfloat16, cuda_device)
    torch.testing.assert_close(
        la.local_flash_attention(*wide).float(),
        la.local_flash_attention_plain(*wide).float(), rtol=1e-2, atol=1e-3)
    assert la.local_flash_attention.launches_by_route == {
        "tensor_core": 0, "fma": 3}
    with pytest.raises(ValueError):
        la.local_flash_attention(q.transpose(1, 2), k, v)   # not contiguous
    with pytest.raises(ValueError):
        la.local_flash_attention(q, k.cpu(), v)             # mixed devices
    assert la.local_flash_attention.launches == 3


@pytest.mark.parametrize("d", [64, 192])
def test_tensor_core_route_realigns_misaligned_operands(cuda_device, d):
    """TMA takes 16-byte aligned base addresses: an operand that is not is
    copied once to a fresh allocation, counted in ``realigned``, and the
    tensor-core kernel runs on the copy, forward and backward."""
    buf = torch.randn(4 * 200 * d + 1, device=cuda_device,
                      dtype=torch.bfloat16)
    q = buf[1:].view(4, 200, d)                 # contiguous, 2 bytes off
    k, v = torch.randn_like(q), torch.randn_like(q)
    dout = torch.randn_like(q)
    la.reset_launches()
    got = _grads(lambda *t: la.local_flash_attention(*t), q, k, v, dout)
    want = _grads(lambda *t: la.local_flash_attention_plain(*t), q, k, v,
                  dout)
    torch.cuda.synchronize()
    assert la.local_flash_attention.realigned == 1
    assert la.local_flash_attention.launches_by_route == {
        "tensor_core": 1, "fma": 0}
    assert la.local_flash_attention.backward_launches_by_route == {
        "tensor_core": 1, "fma": 0}
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=1e-2,
                               atol=1e-3)
    for g, w in zip(got[1:], want[1:]):
        top = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=2e-2 * top)


# The tensor-core route at head dims 192 and 256 (nemotron-4-340b's and
# recurrentgemma's): ragged and whole tiles, GQA groups 1, 4 and 12, a
# window and non-causal, forward at rtol 1e-2 / atol 1e-3 and backward at
# 2e-2 * max|plain|.
@pytest.mark.parametrize("lq,lk,groups", [
    (77, 77, 1), (1000, 1000, 4), (1024, 1024, 12), (333, 1023, 1)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0)])
@pytest.mark.parametrize("d", [192, 256])
def test_tensor_core_route_at_large_head_dims(cuda_device, lq, lk, groups,
                                              causal, window, d):
    q, k, v = _attn_inputs(47, 12, lq, lk, d, groups, torch.bfloat16,
                           cuda_device)
    kw = dict(causal=causal, window=window, kv_groups=groups)
    la.reset_launches()
    got = la.local_flash_attention(q, k, v, **kw)
    want = la.local_flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches_by_route == {
        "tensor_core": 1, "fma": 0}
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3)
    if lq != lk:
        return      # the backward's causal masks assume aligned positions
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(5), device=cuda_device,
        dtype=torch.bfloat16)
    got = _grads(lambda *t: la.local_flash_attention(*t, **kw), q, k, v,
                 dout)
    want = _grads(lambda *t: la.local_flash_attention_plain(*t, **kw), q, k,
                  v, dout)
    again = _grads(lambda *t: la.local_flash_attention(*t, **kw), q, k, v,
                   dout)
    torch.cuda.synchronize()
    assert la.local_flash_attention.backward_launches_by_route == {
        "tensor_core": 2, "fma": 0}
    for name, g, w, r in zip(("dq", "dk", "dv"), got[1:], want[1:],
                             again[1:]):
        top = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=2e-2 * top, msg=name)
        assert torch.equal(g, r), name


# The FMA route at every kind of head dim: below, between and at the
# buckets (1, 5, 48, 80, 100, 160, 192, 255, 256) and past 256 in chunks
# of 256 columns (257, 320, 512), in float32 (2e-5 forward, 1e-4 * max
# backward), float16 and bfloat16 (one rounding of the output: 2e-3 /
# 1e-2 relative; backward 2e-2 * max).
@pytest.mark.parametrize("d", [1, 5, 48, 80, 100, 160, 192, 255, 256, 257,
                               320, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_fma_route_at_any_head_dim(cuda_device, d, dtype):
    if la.route(dtype, d) != "fma":
        pytest.skip("bf16 at this head dim takes the tensor-core route")
    q, k, v = _attn_inputs(48, 8, 300, 300, d, 2, dtype, cuda_device)
    kw = dict(causal=True, window=100, kv_groups=2)
    dout = torch.randn(q.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(6), device=cuda_device, dtype=dtype)
    la.reset_launches()
    got = _grads(lambda *t: la.local_flash_attention(*t, **kw), q, k, v,
                 dout)
    want = _grads(lambda *t: la.local_flash_attention_plain(*t, **kw), q, k,
                  v, dout)
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches_by_route == {
        "tensor_core": 0, "fma": 1}
    assert la.local_flash_attention.backward_launches_by_route == {
        "tensor_core": 0, "fma": 1}
    rtol = {torch.float32: 2e-5, torch.float16: 2e-3,
            torch.bfloat16: 1e-2}[dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=rtol,
                               atol=2e-5 if dtype == torch.float32 else 1e-3)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert g.dtype == dtype, name
        top = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=tol * top, msg=name)


# the narrow bf16 config puts kernel 6's D-192 tensor-core route inside a
# model prefill (nemotron's smoke config has D 16, on the FMA route)
_D192 = ("nemotron-4-340b", dict(d_model=384, n_heads=2, n_kv_heads=1,
                                  param_dtype="bfloat16"))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-72b", "qwen2.5-32b",
                                  "nemotron-4-340b", "d192",
                                  "recurrentgemma-9b", "xlstm-125m",
                                  "qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_lm_prefill_on_the_card_matches_the_cpu(cuda_device, arch):
    if arch == "d192":
        cfg = dataclasses.replace(tcfgs.get_smoke_config(_D192[0]),
                                  **_D192[1])
        assert la.route(cfg.activation_dtype, cfg.head_dim_) == "tensor_core"
    else:
        cfg = tcfgs.get_smoke_config(arch)
    params = init_params(cfg, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(42).integers(
        0, cfg.vocab_size, (2, 77)))
    model = LM(cfg)
    _, want = model.prefill(compute_params(cfg, params), {"tokens": toks},
                            max_len=96)
    on_card = compute_params(cfg, _to(params, cuda_device))
    la.reset_launches()
    cache, got = model.prefill(on_card, {"tokens": toks.to(cuda_device)},
                               max_len=96)
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches == \
        cfg.layer_kinds().count("attn")
    torch.testing.assert_close(got.cpu(), want, rtol=5e-2, atol=5e-2)
    lg, _ = model.decode_step(on_card, cache, toks[:, :1].to(cuda_device))
    assert bool(torch.isfinite(lg).all())


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def _boundary(x, nz, route, **kw):
    """The converter boundary on ``route``: the wrapper for the route it
    picks (its per-route counter asserted), the C entry point for the
    other."""
    adc_dac.reset_launches()
    if route == "wrapper":
        out = adc_dac.converter_boundary(x, nz, **kw)
        torch.cuda.synchronize()
        assert adc_dac.converter_boundary.launches == 1
        return out
    out = torch.empty_like(x)
    adc_dac._launch(x, nz, out, route, kw["dac_bits"], kw["adc_bits"],
                    kw["noise_std"])
    torch.cuda.synchronize()
    assert adc_dac.converter_boundary.launches == 0
    return out


def _assert_bit_equal(got, want):
    """Equal values, NaN where ``want`` has NaN (its bits may differ)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("shape,dtype,noise", [
    ((2048, 2048), torch.float32, "f32"), ((2048, 2048), torch.float32, None),
    ((4096, 2048), torch.bfloat16, "f32"), ((4096, 2048), torch.bfloat16,
                                            None),
    ((4096, 2048), torch.bfloat16, "x"), ((7, 130), torch.float32, "f32"),
    ((1, 1), torch.bfloat16, None)])
@pytest.mark.parametrize("bits", [(8, 8), (6, 8), (4, 12), (16, 16)])
@pytest.mark.parametrize("route", adc_dac.ROUTES)
def test_converter_boundary_matches_plain_version(cuda_device, shape, dtype,
                                                  noise, bits, route):
    """Each route, bit-equal to the plain version: the wrapper's route for
    these shapes is resident (asserted), the streamed one is taken
    through the C entry point.  Without noise the resident route reads
    its output from a table of DAC codes up to 12 bits, and computes it
    at 16."""
    rng = np.random.default_rng(50)
    x = torch.from_numpy(rng.random(shape, dtype=np.float32) * 1.2 - 0.1
                         ).to(device=cuda_device, dtype=dtype)
    nz = None
    if noise is not None:
        nz = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                              ).to(device=cuda_device,
                                   dtype=torch.float32 if noise == "f32"
                                   else dtype)
    dac, adc = bits
    kw = dict(dac_bits=dac, adc_bits=adc, noise_std=0.02)
    got = _boundary(x, nz, "wrapper" if route == "resident" else route, **kw)
    if route == "resident":
        assert adc_dac.converter_boundary.launches_by_route == {
            "resident": 1, "streamed": 0}
    _assert_bit_equal(got, adc_dac.converter_boundary_plain(x, nz, **kw))


_SPECIALS = ["nan in x", "nan in noise", "+inf in x", "-inf in x",
             "inf in noise", "all negative"]


@pytest.mark.parametrize("case", _SPECIALS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", adc_dac.ROUTES)
def test_converter_boundary_keeps_nan_and_inf(cuda_device, case, dtype,
                                             route):
    """NaN where the plain version (and the reference) has it: a NaN or
    +inf in x makes the scale NaN or inf and every element NaN, a NaN in
    the noise its own element; an all-negative x takes the floor 1e-20
    in x's dtype."""
    rng = np.random.default_rng(51)
    x = rng.random((300, 1000), dtype=np.float32) * 1.2 - 0.1
    nz = rng.standard_normal(x.shape).astype(np.float32)
    where = (slice(None, None, 5), slice(3, None, 7))
    if case == "all negative":
        x = -x - 0.2
    elif case.endswith("in x"):
        x[where] = {"nan": np.nan, "+inf": np.inf,
                    "-inf": -np.inf}[case.split()[0]]
    elif case == "nan in noise":
        nz[where] = np.nan
    else:
        nz[where] = -np.inf
        nz[1::4, ::3] = np.inf
    x = torch.from_numpy(x).to(device=cuda_device, dtype=dtype)
    nz = torch.from_numpy(nz).to(cuda_device)
    kw = dict(dac_bits=6, adc_bits=8, noise_std=0.02)
    got = _boundary(x, nz, "wrapper" if route == "resident" else route, **kw)
    want = adc_dac.converter_boundary_plain(x, nz, **kw)
    _assert_bit_equal(got, want)
    assert bool(want.isnan().any()) == (case in ("nan in x", "+inf in x",
                                                 "nan in noise"))


@pytest.mark.parametrize("route", adc_dac.ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("noisy", [True, False])
def test_converter_boundary_takes_misaligned_views(cuda_device, route, dtype,
                                                   noisy):
    """x and noise 4 (2) bytes past a 16-byte boundary: both routes run
    their scalar loops, with the same bits."""
    rng = np.random.default_rng(52)
    shape = (257, 1031)
    x = _misaligned(torch.from_numpy(rng.random(shape, dtype=np.float32))
                    .to(device=cuda_device, dtype=dtype))
    nz = _misaligned(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(cuda_device)) if noisy else None
    assert x.data_ptr() % 16 and (nz is None or nz.data_ptr() % 16)
    kw = dict(dac_bits=8, adc_bits=8, noise_std=0.02)
    got = _boundary(x, nz, "wrapper" if route == "resident" else route, **kw)
    _assert_bit_equal(got, adc_dac.converter_boundary_plain(x, nz, **kw))


def test_converter_boundary_routes_by_size_and_counts(cuda_device):
    """(2048, 2048) f32 holds on chip: one call, one launch of the
    resident kernel; (4096, 2048) f32 (32 MiB) does not: the streamed
    route.  Each call is counted once, under its route."""
    gen = torch.Generator(device=cuda_device).manual_seed(53)
    adc_dac.reset_launches()
    for shape in ((2048, 2048), (4096, 2048), (2048, 2048)):
        x = torch.rand(shape, generator=gen, device=cuda_device)
        nz = torch.randn(shape, generator=gen, device=cuda_device)
        got = adc_dac.converter_boundary(x, nz, noise_std=0.02)
        _assert_bit_equal(got, adc_dac.converter_boundary_plain(
            x, nz, noise_std=0.02))
    assert adc_dac.converter_boundary.launches == 3
    assert adc_dac.route(4096 * 2048, torch.float32,
                         *adc_dac._limits(x.device)) == "streamed"
    assert adc_dac.converter_boundary.launches_by_route == {"resident": 2,
                                                           "streamed": 1}


def test_converter_boundary_raises_on_a_refused_launch(cuda_device):
    """The resident route refuses an x larger than the card holds; the
    launch raises and nothing falls back."""
    x = torch.rand(4096, 2048, device=cuda_device)
    with pytest.raises(RuntimeError, match="CUDA error"):
        adc_dac._launch(x, None, torch.empty_like(x), "resident", 8, 8, 0.0)


def _grads(fn, q, k, v, dout):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


# (lq, lk, d, groups, dv): dv None is d; MLA's D 192 / Dv 128 and D 256
# with GQA take the tensor-core route's own widths in bf16 (the FMA route
# pads V to D in float32)
@pytest.mark.parametrize("lq,lk,d,groups,dv", [
    (128, 128, 64, 1, None), (256, 256, 32, 2, None), (77, 77, 64, 1, None),
    (200, 200, 16, 4, None), (1000, 1000, 64, 1, None),
    (130, 130, 128, 2, None), (256, 128, 64, 1, None), (5, 300, 8, 8, None),
    (300, 300, 192, 2, 128), (517, 517, 192, 1, 128),
    (1000, 1000, 256, 4, None), (333, 333, 256, 8, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64),
                                           (False, 0), (False, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_matches_plain_autograd(
        cuda_device, lq, lk, d, groups, dv, causal, window, dtype):
    q, k, v = _attn_inputs(42, 8, lq, lk, d, groups, dtype, cuda_device)
    v = v[..., :dv or d].contiguous()
    dout = torch.randn((*q.shape[:2], v.shape[2]), generator=torch.Generator(
        device=cuda_device).manual_seed(3), device=cuda_device, dtype=dtype)
    kw = dict(causal=causal, window=window, kv_groups=groups)
    la.reset_launches()
    got = _grads(lambda *t: la.local_flash_attention(*t, **kw), q, k, v,
                 dout)
    want = _grads(lambda *t: la.local_flash_attention_plain(*t, **kw), q, k,
                  v, dout)
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches == 1
    assert la.local_flash_attention.backward_launches == 1
    assert la.local_flash_attention.backward_launches_by_route[
        la.route(dtype, d)] == 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        assert g.dtype == dtype, name
        top = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=tol * max(top, 1e-30), msg=name)


@pytest.mark.parametrize("bh,l,groups,d,dv,window", [
    (32, 517, 4, 64, 64, 0), (128, 1024, 1, 64, 64, 0),
    (64, 1024, 1, 192, 128, 0), (32, 1000, 16, 256, 256, 300)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_is_deterministic(cuda_device, dtype, bh, l,
                                                   groups, d, dv, window):
    """Two launches give bit-equal gradients, at (32, 517, 64) with GQA,
    at the training shape (128, 1024, 64), at MLA's D 192 / Dv 128 and at
    D 256 with GQA and a window."""
    q, k, v = _attn_inputs(43, bh, l, l, d, groups, dtype, cuda_device)
    v = v[..., :dv].contiguous()
    dout = torch.randn((bh, l, dv), device=cuda_device, dtype=dtype)
    kw = dict(kv_groups=groups, window=window)
    first = _grads(lambda *t: la.local_flash_attention(*t, **kw), q, k, v,
                   dout)
    second = _grads(lambda *t: la.local_flash_attention(*t, **kw), q, k, v,
                    dout)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("h,hkv,l,d,dv,dtype", [
    (16, 16, 1024, 192, 128, torch.bfloat16),
    (16, 4, 517, 192, 128, torch.bfloat16),
    (8, 8, 1024, 192, 128, torch.float32),
    (8, 2, 333, 12, 8, torch.float32),
    (4, 4, 200, 64, 1, torch.float32)])
def test_flash_attention_with_narrower_v_matches_plain(cuda_device, h, hkv,
                                                       l, d, dv, dtype):
    """V of Dv < D columns (MLA: 128 against 192): the tensor-core route
    launches at Dv, unpadded (the launch counts by shape say so); the FMA
    route, and a Dv the tensor-core route does not take, pad V with zero
    columns (``launch_dv``) and slice the output.  Out and dV have the
    caller's Dv columns; forward and gradients within the kernel's bounds
    of the plain version, which takes Dv as it is."""
    q, k, v = _attn_inputs(47, h, l, l, d, h // hkv, dtype, cuda_device)
    v = v[..., :dv].contiguous()
    dout = torch.randn((h, l, dv), generator=torch.Generator(
        device=cuda_device).manual_seed(5), device=cuda_device, dtype=dtype)
    kw = dict(causal=True, kv_groups=h // hkv, scale=d ** -0.5)
    la.reset_launches()
    got = _grads(lambda *t: la.local_flash_attention(*t, **kw), q, k, v,
                 dout)
    want = _grads(lambda *t: la.local_flash_attention_plain(*t, **kw), q, k,
                  v, dout)
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches_by_route[la.route(dtype, d)] \
        == 1
    assert la.local_flash_attention.backward_launches == 1
    width = la.launch_dv(dtype, d, dv)
    assert (width == dv) == (dtype == torch.bfloat16)
    key = la.shape_key(h, hkv, l, l, d, True, 0, width)
    assert la.local_flash_attention.launches_by_shape == {key: 1}
    assert la.local_flash_attention.backward_launches_by_shape == {key: 1}
    assert got[0].shape == (h, l, dv) and got[3].shape == v.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got[0], want[0], rtol=2e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   rtol=1e-2, atol=1e-3)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        top = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=0,
                                   atol=tol * max(top, 1e-30), msg=name)


def test_moe_combine_is_deterministic_on_the_card(cuda_device):
    """Two calls of ``moe_apply`` on the same inputs give the same bits
    (the combine gathers each token's k slots and adds them in expert
    order; no atomics), in bf16 with many tokens per expert."""
    from repro_torch.models.moe import moe_apply
    cfg = tcfgs.get_config("qwen2-moe-a2.7b")
    cfg = dataclasses.replace(cfg, d_model=256, moe=dataclasses.replace(
        cfg.moe, d_expert=64, d_shared=64))
    params = compute_params(cfg, init_params(cfg, device=cuda_device))
    p = {k: v[0] for k, v in params["stack"]["0_attn"]["mlp"].items()}
    x = torch.randn((4, 1023, cfg.d_model), generator=torch.Generator(
        device=cuda_device).manual_seed(6), device=cuda_device,
        dtype=torch.bfloat16)
    first, aux1 = moe_apply(cfg, p, x)
    second, aux2 = moe_apply(cfg, p, x)
    assert torch.equal(first, second) and torch.equal(aux1, aux2)
    assert bool(torch.isfinite(first).all())


def test_moe_backward_is_bit_equal_on_the_card(cuda_device):
    """Two backward passes of ``moe_apply`` at qwen2-moe-a2.7b's published
    widths (60 experts of 1408, top 4, 4 shared, d_model 2048), bf16, 4 x
    1024 tokens, give bit-equal gradients to x and every parameter: the
    slot gathers' backward adds each token's slots in expert order, with
    no atomics."""
    from repro_torch.models.moe import moe_apply
    cfg = dataclasses.replace(tcfgs.get_config("qwen2-moe-a2.7b"),
                              n_layers=1)
    params = compute_params(cfg, init_params(cfg, device=cuda_device))
    p = {k: v[0].detach() for k, v in
         params["stack"]["0_attn"]["mlp"].items()}
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn((4, 1024, cfg.d_model), generator=gen,
                    device=cuda_device, dtype=torch.bfloat16)
    g = torch.randn(x.shape, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    runs = []
    for _ in range(2):
        leaves_ = [x.clone().requires_grad_()] + [
            t.clone().requires_grad_() for t in p.values()]
        out, aux = moe_apply(cfg, dict(zip(p, leaves_[1:])), leaves_[0])
        runs.append(torch.autograd.grad((out * g).float().sum() + aux,
                                        leaves_))
    for name, a, b in zip(["x", *p], *runs):
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), name
    assert float(runs[0][0].float().abs().max()) > 0


def test_gqa_wrapper_gradient_reaches_q_k_v(cuda_device):
    q = torch.randn(2, 8, 333, 64, device=cuda_device, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(2, 2, 333, 64, device=cuda_device, dtype=torch.bfloat16,
                    requires_grad=True)
    v = torch.randn(2, 2, 333, 64, device=cuda_device, dtype=torch.bfloat16,
                    requires_grad=True)
    la.reset_launches()
    ops.gqa_flash_attention(q, k, v).float().square().sum().backward()
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches == 1
    assert la.local_flash_attention.backward_launches == 1
    for t in (q, k, v):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
        assert float(t.grad.float().abs().max()) > 0.0


def test_flash_attention_without_grad_writes_no_lse(cuda_device):
    """Serving's forward (no gradient) and training's (log-sum-exp kept)
    give bit-equal outputs."""
    q, k, v = _attn_inputs(44, 8, 300, 300, 64, 2, torch.bfloat16,
                           cuda_device)
    with torch.no_grad():
        plain = la.local_flash_attention(q, k, v, kv_groups=2)
    qg = q.clone().requires_grad_()
    with_grad = la.local_flash_attention(qg, k, v, kv_groups=2)
    assert with_grad.grad_fn is not None
    assert torch.equal(plain, with_grad.detach())


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-72b",
                                  "recurrentgemma-9b", "xlstm-125m",
                                  "qwen2-moe-a2.7b", "deepseek-v3-671b"])
def test_lm_loss_and_grads_on_the_card_match_the_cpu(cuda_device, arch):
    """The training loss (bf16 activations, float32 master weights, every
    block rematerialized) on the card, through kernel 6's forward and
    backward, against the same loss on the CPU.  The mLSTM's and sLSTM's
    input-gate biases have a gradient of exactly 0 (a shift of the input
    gate at every step moves the stabilizer m by as much and leaves C, n
    and h as they are), so theirs is round-off on both sides (1e-5 of the
    largest gradient on the CPU in bf16): held to 1e-3 of the largest
    gradient instead."""
    cfg = tcfgs.get_smoke_config(arch)
    params = init_params(cfg, device="cpu")
    toks = np.random.default_rng(44).integers(0, cfg.vocab_size, (2, 65))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    want, _, want_g = loss_and_grads(LM(cfg), params, batch)
    la.reset_launches()
    got, _, got_g = loss_and_grads(
        LM(cfg), _to(params, cuda_device),
        {k: v.to(cuda_device) for k, v in batch.items()})
    torch.cuda.synchronize()
    n_attn = cfg.layer_kinds().count("attn")
    plan = cfg.layer_plan()
    # the stacked blocks are rematerialized: their forward runs twice
    n_stacked = plan.n_super * plan.super_block.count("attn")
    assert la.local_flash_attention.launches == n_attn + n_stacked
    assert la.local_flash_attention.backward_launches == n_attn
    torch.testing.assert_close(got.cpu(), want, rtol=5e-2, atol=5e-2)
    gmax = max(float(w.abs().max()) for _, w in leaves(want_g))
    for (path, g), (_, w) in zip(leaves(got_g), leaves(want_g)):
        assert g.dtype == torch.float32, path
        top = float(w.abs().max())
        zero_grad = tuple(path[-2:]) in (("mlstm", "b_if"),
                                         ("slstm", "b_i"))
        torch.testing.assert_close(g.cpu(), w, rtol=5e-2,
                                   atol=1e-3 * gmax if zero_grad
                                   else 5e-2 * max(top, 1e-30),
                                   msg="/".join(path))


def test_training_resumes_bit_exact_on_the_card(cuda_device, tmp_path):
    """A crash at step 13 of 20 and a restore from the step-10 checkpoint
    reproduce the uninterrupted run's parameters bit for bit."""
    kw = dict(steps=20, batch=2, seq=64, device=cuda_device, log_every=100)
    crashed = {"done": False}

    def fault(step):
        if step == 13 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected preemption")

    (want, _), _, _ = ttrain.train_loop("stablelm-1.6b", **kw)
    (got, _), _, _ = ttrain.train_loop(
        "stablelm-1.6b", ckpt_dir=str(tmp_path), fault_hook=fault, **kw)
    assert crashed["done"]
    for (path, a), (_, b) in zip(leaves(got), leaves(want)):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("setting", [{"REPRO_REMAT_POLICY": "dots"},
                                     {"REPRO_REMAT_GROUP": "2"}])
def test_remat_switches_on_the_card_match_full(cuda_device, monkeypatch,
                                               setting):
    """xlstm-125m's smoke loss (two super-blocks) under each remat switch
    on the card: loss and gradients within 1e-6 relative of "full"."""
    cfg = tcfgs.get_smoke_config("xlstm-125m")
    params = _to(init_params(cfg, device="cpu"), cuda_device)
    toks = torch.from_numpy(np.random.default_rng(45).integers(
        0, cfg.vocab_size, (2, 33))).to(cuda_device)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for k in ("REPRO_REMAT_POLICY", "REPRO_REMAT_GROUP"):
        monkeypatch.delenv(k, raising=False)
    want, _, want_g = loss_and_grads(LM(cfg), params, batch)
    for k, v in setting.items():
        monkeypatch.setenv(k, v)
    got, _, got_g = loss_and_grads(LM(cfg), params, batch)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    for (path, g), (_, w) in zip(leaves(got_g), leaves(want_g)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * float(
            w.abs().max()), msg="/".join(path))


def test_recurrent_serving_on_the_card(cuda_device):
    """The smoke recurrentgemma served on the card past its window (8):
    every request done, its tokens equal to an offline prefill and greedy
    decode on the card, every prefill's attention through kernel 6."""
    cfg = tcfgs.get_smoke_config("recurrentgemma-9b")
    params = init_params(cfg, device=cuda_device)
    prompts = [[5, 9, 2, 7, 1, 3, 8, 6, 4, 2, 2], [11, 3, 8]]
    la.reset_launches()
    eng = ServingEngine(cfg, params, batch_slots=1, max_len=48)
    for rid, pr in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=pr, max_new_tokens=12))
    done = sorted(eng.run_to_completion(), key=lambda r: r.rid)
    assert la.local_flash_attention.launches == \
        cfg.layer_kinds().count("attn") * len(prompts)
    model, cp = LM(cfg), compute_params(cfg, params)
    for req in done:
        cache, lg = model.prefill(cp, {"tokens": torch.tensor(
            [req.prompt], device=cuda_device)}, max_len=48)
        toks = [int(torch.argmax(lg[0]))]
        for _ in range(11):
            lg, cache = model.decode_step(cp, cache, torch.tensor(
                [[toks[-1]]], device=cuda_device))
            toks.append(int(torch.argmax(lg[0])))
        assert req.out_tokens == toks


def test_adafactor_and_error_feedback_on_the_card_match_the_cpu(
        cuda_device):
    """One Adafactor step (a factored matrix, an unfactored vector) and one
    int8 error-feedback round on the card against the CPU: updates and
    state within rtol 1e-5 / atol 1e-6 * max, the int8 codes and scale
    equal, the residual within 1e-6 * the scale."""
    rng = np.random.default_rng(46)
    shapes = {"w": (512, 768), "b": (512,)}
    host = {k: {"p": torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)), "g": torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32) * 1e-2)} for k, sh in shapes.items()}
    out = {}
    for dev in ("cpu", cuda_device):
        p = {k: v["p"].to(dev) for k, v in host.items()}
        g = {k: v["g"].to(dev) for k, v in host.items()}
        opt = adafactor(1e-2)
        upd, st, _ = opt.update(g, opt.init(p), p, 0)
        q, scale, res = ef_compress({"w": g["w"]}, ef_init({"w": g["w"]}))
        out[str(dev)] = (upd, st, q["w"], scale["w"], res["w"])
    (cu, cs, cq, csc, cr), (gu, gs, gq, gsc, gr) = out["cpu"], out[
        str(cuda_device)]
    for (path, a), (_, b) in zip(leaves({"u": gu, "s": gs}),
                                 leaves({"u": cu, "s": cs})):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5,
                                   atol=1e-6 * float(b.abs().max()),
                                   msg="/".join(path))
    assert torch.equal(gq.cpu(), cq) and float(gsc) == float(csc)
    torch.testing.assert_close(gr.cpu(), cr, rtol=0, atol=1e-6 * float(csc))


# --- the case study -------------------------------------------------------------


def test_op_profiler_charges_queued_work_to_other(cuda_device):
    """Matmuls queued before an fft bracket finish before it starts."""
    a = torch.randn(4096, 4096, device=cuda_device) / 64.0
    x = torch.randn(256, 256, device=cuda_device)

    def queue():
        b = a
        for _ in range(8):
            b = b @ a
        return b

    queue()
    torch.fft.fft2(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    queue()
    torch.cuda.synchronize()
    queued_s = time.perf_counter() - t0
    prof = OpProfiler()
    prof.start()
    queue()
    prof.run("fft", torch.fft.fft2, x)
    prof.stop()
    assert prof.seconds["fft"] < 0.25 * queued_s
    assert prof.total_s >= 0.9 * queued_s


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-72b"])
def test_flops_of_the_smoke_loss_equal_on_cuda_and_cpu(cuda_device, arch):
    cfg = tcfgs.get_smoke_config(arch)
    params = init_params(cfg, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)))
    batch = {"tokens": tokens, "labels": tokens}
    model = LM(cfg)
    loss = lambda p, b: model.loss(p, b)[0]
    want = flops_by_category(loss, params, batch)
    la.reset_launches()
    got = flops_by_category(
        loss, map_tree(lambda t: t.to(cuda_device), params),
        {k: v.to(cuda_device) for k, v in batch.items()})
    assert la.local_flash_attention.launches == cfg.n_layers
    assert got == want


# one run's (calls, samples in, samples out) by category, the reference's
_SUITE_COUNTS = {"fourier_transform": {"fft": (1, 2_250_000, 2_250_000)},
                 "convolution": {"conv": (4, 80_000, 158_404)},
                 "cnn_training": {"conv": (4, 945_504, 3_145_728)}}


@pytest.mark.parametrize("name", list(_SUITE_COUNTS))
def test_suite_benchmark_on_the_card_matches_the_cpu(cuda_device, name):
    calls = []

    class Recording(OpProfiler):
        def run(self, category, fn, *args, **kwargs):
            out = super().run(category, fn, *args, **kwargs)
            calls.append((fn, args, out))
            return out

    profs = []

    def profiler():
        profs.append(Recording())
        return profs[-1]

    row = amdahl_suite.run_one(name, dict(amdahl_suite.BENCHMARKS)[name],
                               device=cuda_device, profiler=profiler)
    assert 0.0 < row.fraction <= 1.0
    warm, timed = profs
    want = _SUITE_COUNTS[name]
    assert {c: (warm.calls[c], warm.samples_in[c], warm.samples_out[c])
            for c in warm.calls} == want
    assert dict(timed.calls) == {c: amdahl_suite.REPEATS * v[0]
                                 for c, v in want.items()}
    fn, args, out = calls[0]
    assert out.is_cuda and all(a.is_cuda for a in args
                               if isinstance(a, torch.Tensor))
    ref = fn(*[a.cpu() if isinstance(a, torch.Tensor) else a for a in args])
    assert bool(torch.isfinite(out).all())
    err = float((out.cpu() - ref).abs().max())
    assert err <= 1e-4 * float(ref.abs().max())


# Kernel 6 at the encoder-decoder's and the vision model's new cases, on
# the tensor-core route against its plain version at the file's bounds:
# one query row (decode's cross-attention, Lq = 1) against Lk 77 and 1024
# at D 64 and 128, groups 1 and 7; seamless-m4t-large-v2's cross-attention
# (64 rows, Lq 128 or 512 against 1024 frames, D 64) and its non-causal
# encoder forward and backward; llava-next-34b's GQA 7 at D 128.
@pytest.mark.parametrize("lk", [77, 1024])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("groups", [1, 7])
def test_tensor_core_route_at_one_query(cuda_device, lk, d, groups):
    q, k, v = _attn_inputs(48, 28, 1, lk, d, groups, torch.bfloat16,
                           cuda_device)
    la.reset_launches()
    got = la.local_flash_attention(q, k, v, causal=False, kv_groups=groups)
    want = la.local_flash_attention_plain(q, k, v, causal=False,
                                          kv_groups=groups)
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches_by_route == {
        "tensor_core": 1, "fma": 0}
    assert got.shape == (28, 1, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3)


@pytest.mark.parametrize("bh,bhkv,lq,lk,d,causal", [
    (64, 64, 128, 1024, 64, False),      # seamless cross-attention, prefill
    (32, 32, 512, 1024, 64, False),      # seamless cross-attention, training
    (64, 64, 1024, 1024, 64, False),     # seamless encoder
    (56, 8, 1088, 1088, 128, True),      # llava GQA 7, one request
    (56, 8, 333, 333, 128, False)])
def test_tensor_core_route_at_the_multimodal_shapes(cuda_device, bh, bhkv,
                                                    lq, lk, d, causal):
    """Forward at rtol 1e-2 / atol 1e-3 and backward within 2e-2 *
    max|plain|, bit-equal on a repeat; Lq != Lk only without a causal
    mask (its masks assume aligned positions)."""
    g = bh // bhkv
    rng = np.random.default_rng(49)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=cuda_device, dtype=torch.bfloat16)
        for shape in ((bh, lq, d), (bhkv, lk, d), (bhkv, lk, d)))
    dout = torch.from_numpy(rng.standard_normal((bh, lq, d)).astype(
        np.float32)).to(device=cuda_device, dtype=torch.bfloat16)
    kw = dict(causal=causal, kv_groups=g)
    la.reset_launches()
    got = _grads(lambda *t: la.local_flash_attention(*t, **kw), q, k, v,
                 dout)
    want = _grads(lambda *t: la.local_flash_attention_plain(*t, **kw), q, k,
                  v, dout)
    again = _grads(lambda *t: la.local_flash_attention(*t, **kw), q, k, v,
                   dout)
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches_by_route == {
        "tensor_core": 2, "fma": 0}
    assert la.local_flash_attention.backward_launches_by_route == {
        "tensor_core": 2, "fma": 0}
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=1e-2,
                               atol=1e-3)
    for name, a, w, r in zip(("dq", "dk", "dv"), got[1:], want[1:],
                             again[1:]):
        top = float(w.float().abs().max())
        torch.testing.assert_close(a.float(), w.float(), rtol=0,
                                   atol=2e-2 * top, msg=name)
        assert torch.equal(a, r), name


def _multimodal_batch(cfg, b, s, dev, labels=False):
    rng = np.random.default_rng(50)
    s_text = s - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    toks = rng.integers(0, cfg.vocab_size, (b, s_text + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev)}
    if labels:
        batch["labels"] = torch.from_numpy(toks[:, 1:]).to(dev)
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, s // 2, cfg.d_model)).astype(np.float32)).to(dev)
    if cfg.frontend == "vision":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)).to(dev)
    return batch


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "llava-next-34b"])
def test_multimodal_prefill_and_decode_on_the_card_match_the_cpu(
        cuda_device, arch):
    """Both families' smoke prefill and 3 decode steps on the card against
    the CPU at the bf16 bound (5e-2): one launch per encoder layer,
    decoder self-attention and cross-attention a prefill, and one
    cross-attention launch per decoder layer a decode step."""
    cfg = tcfgs.get_smoke_config(arch)
    params = compute_params(cfg, init_params(cfg, device="cpu"))
    on_card = _to(params, cuda_device)
    batch = _multimodal_batch(cfg, 2, 40, "cpu")
    model = LM(cfg)
    max_len = 48 + cfg.frontend_tokens
    cpu_cache, want = model.prefill(params, batch, max_len=max_len)
    la.reset_launches()
    cache, got = model.prefill(on_card, _to(batch, cuda_device),
                               max_len=max_len)
    torch.cuda.synchronize()
    per_prefill = cfg.encoder_layers + cfg.n_layers * (
        2 if cfg.is_encdec else 1)
    assert la.local_flash_attention.launches == per_prefill
    torch.testing.assert_close(got.cpu(), want, rtol=5e-2, atol=5e-2)
    toks = batch["tokens"][:, :1]
    for _ in range(3):
        want, cpu_cache = model.decode_step(params, cpu_cache, toks)
        got, cache = model.decode_step(on_card, cache, toks.to(cuda_device))
        torch.testing.assert_close(got.cpu(), want, rtol=5e-2, atol=5e-2)
        toks = torch.argmax(want, dim=-1, keepdim=True)
    torch.cuda.synchronize()
    assert la.local_flash_attention.launches == per_prefill + 3 * (
        cfg.n_layers if cfg.is_encdec else 0)


def test_encdec_loss_and_grads_on_the_card_match_the_cpu(cuda_device):
    """seamless's smoke training loss on the card (every encoder and
    decoder block rematerialized: each forward twice, each backward once)
    against the CPU at the bf16 bound."""
    cfg = tcfgs.get_smoke_config("seamless-m4t-large-v2")
    params = init_params(cfg, device="cpu")
    batch = _multimodal_batch(cfg, 2, 64, "cpu", labels=True)
    want, _, want_g = loss_and_grads(LM(cfg), params, batch)
    la.reset_launches()
    got, _, got_g = loss_and_grads(LM(cfg), _to(params, cuda_device),
                                   _to(batch, cuda_device))
    torch.cuda.synchronize()
    n = cfg.encoder_layers + 2 * cfg.n_layers
    assert la.local_flash_attention.launches == 2 * n
    assert la.local_flash_attention.backward_launches == n
    torch.testing.assert_close(got.cpu(), want, rtol=5e-2, atol=5e-2)
    for (path, g), (_, w) in zip(leaves(got_g), leaves(want_g)):
        top = float(w.abs().max())
        torch.testing.assert_close(g.cpu(), w, rtol=5e-2,
                                   atol=5e-2 * max(top, 1e-30),
                                   msg="/".join(path))


def test_meshed_moe_prefill_on_the_card_equals_unmeshed(cuda_device):
    """qwen2-moe-a2.7b's smoke model on a (1, 1) ``(data, model)`` mesh of
    one NCCL rank, params, tokens and cache DTensors: its prefill and two
    greedy decode steps give the unmeshed run's logits and cache (within
    1e-6; on one device every DTensor op is its local op), and kernel 6
    launches once a layer through the DTensor path."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.compat import enter_mesh
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.distributed.specs import batch_pspecs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.params import param_pspecs

    cfg = tcfgs.get_smoke_config("qwen2-moe-a2.7b")
    params = compute_params(cfg, _to(init_params(cfg, device="cpu"),
                                     cuda_device))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (4, 64))).to(cuda_device)
    model = LM(cfg)

    def serve(p, t):
        cache, lg = model.prefill(p, {"tokens": t}, max_len=80)
        logits = [lg]
        for _ in range(2):
            nxt = torch.argmax(lg, dim=-1, keepdim=True)
            lg, cache = model.decode_step(p, cache, nxt)
            logits.append(lg)
        return logits, cache

    want, want_cache = serve(params, toks)
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh((1, 1), ("data", "model"))
        enter_mesh(mesh)
        dparams = distribute_tree(params, param_pspecs(
            cfg, fsdp_size=0, tp_size=1), mesh)
        dtoks = distribute_tree({"tokens": toks}, batch_pspecs(
            {"tokens": toks}, mesh.mesh_dim_names, dp_total=1),
            mesh)["tokens"]
        seen = []
        on_shards = ops._on_shards

        def spy(q, k, v, **kw):
            seen.append(all(isinstance(t, DTensor) for t in (q, k, v)))
            return on_shards(q, k, v, **kw)

        la.reset_launches()
        ops._on_shards = spy
        try:
            cache, lg = model.prefill(dparams, {"tokens": dtoks}, max_len=80)
        finally:
            ops._on_shards = on_shards
        torch.cuda.synchronize()
        assert la.local_flash_attention.launches == cfg.n_layers
        assert seen == [True] * cfg.n_layers
        got = [lg]
        for _ in range(2):
            nxt = torch.argmax(lg.full_tensor(), dim=-1, keepdim=True)
            lg, cache = model.decode_step(dparams, cache, nxt)
            got.append(lg)
    finally:
        enter_mesh(None)
        dist.destroy_process_group()
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    for g, w in zip(got, want):
        assert float((whole(g) - w).abs().max()) <= 1e-6
    for (path, a), (_, b) in zip(leaves(cache), leaves(want_cache)):
        assert float((whole(a).float() - b.float()).abs().max()) <= 1e-6, \
            "/".join(path)
