"""The port's profiler and complexity modules on the CPU, against the
reference.

``core.profiler.flops_by_category`` counts the aten ops a function
dispatches; the reference walks its jaxpr.  Tolerances, and why:

* matmul, conv and fft FLOPs are integer-valued counts computed from
  shapes by the same rules: equal to rtol 1e-9 (exact in practice), on
  hand-made functions and on the stablelm-1.6b, qwen2-72b,
  seamless-m4t-large-v2 and llava-next-34b smoke ``LM.loss`` (the
  reference's ``model.loss`` at the planner's batch of 2 x 32 tokens,
  with 16 encoder frames or the vision patches where the config takes
  them, the port's at the same inputs with the reference's weights
  carried over by ``convert.lm_params_from_numpy``);
* the same counts, every category, on ``meta`` and on ``cpu``: equal;
* 'other' is an approximate count by design (one per produced element of
  every non-contraction op).  The reference counts layout ops
  (transpose, reshape, broadcast) that are views in PyTorch and count
  nothing here, and its attention's softmax is several ops where
  PyTorch's is one.  The port's count over the reference's is 0.519 for
  stablelm-1.6b and 0.549 for qwen2-72b; it is held within [0.5, 2];
* ``traffic_bytes`` on a matmul and an elementwise chain: equal;
* the kernel wrappers' charges: equal to the reference's walk of its
  ``pallas_call`` (DFT stages, converter boundary) and of its chunked
  attention (matmul);
* complexity crossovers and advantages: pure Python, equal;
* the telemetry -> plan round trip: the same calls and samples, and the
  same offload verdict, as a hand ``OpProfiler`` run.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jcfgs
from repro.core import complexity as jcomplexity
from repro.core import profiler as jprof
from repro.kernels import adc_dac as jadc
from repro.kernels import optical_dft as jdft
from repro.models import LM as JLM
from repro.models import init_params as jinit
from repro.models.attention import _sdpa_chunked
from repro_torch import configs as tcfgs
from repro_torch import runtime as trt
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import PROTOTYPE_4F, CategoryProfile, plan_offload
from repro_torch.core import complexity
from repro_torch.core.profiler import (OpProfiler, flops_by_category,
                                       traffic_bytes)
from repro_torch.kernels import adc_dac, local_attention, ops, optical_dft
from repro_torch.models import LM
from repro_torch.models.params import map_tree

ARCHS = ["stablelm-1.6b", "qwen2-72b", "seamless-m4t-large-v2",
         "llava-next-34b"]
OTHER_BAND = (0.5, 2.0)


def _t(shape, seed=0, dtype=np.float32):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(dtype))


def _offloadable(cats):
    return {k: cats.get(k, 0.0) for k in ("matmul", "conv", "fft")}


# --- flops_by_category on hand-made functions -----------------------------------

def test_flops_matmul_exact():
    cats = flops_by_category(lambda a, b: a @ b, torch.zeros(8, 16),
                             torch.zeros(16, 32))
    assert cats["matmul"] == pytest.approx(2 * 8 * 16 * 32)
    ref = jprof.flops_by_category(lambda a, b: a @ b, jnp.zeros((8, 16)),
                                  jnp.zeros((16, 32)))
    assert cats["matmul"] == ref["matmul"]


def test_flops_loop_counts_each_trip():
    """A Python loop of 7 products counts what the reference's scan of
    length 7 counts: its trip-count multiplier is implicit."""
    def f(x):
        for _ in range(7):
            x = x @ x
        return x
    cats = flops_by_category(f, torch.zeros(16, 16))
    assert cats["matmul"] == pytest.approx(7 * 2 * 16 ** 3)
    ref = jprof.flops_by_category(
        lambda x: jax.lax.scan(lambda c, _: (c @ c, None), x, None,
                               length=7)[0], jnp.zeros((16, 16)))
    assert cats["matmul"] == ref["matmul"]
    assert "__while_unknown_trips__" not in cats


def test_flops_fft_and_conv_categories():
    cats = flops_by_category(torch.fft.fft2, torch.zeros(32, 32))
    assert cats.get("fft", 0) > 0
    ref = jprof.flops_by_category(lambda x: jnp.fft.fft2(x),
                                  jnp.zeros((32, 32)))
    assert cats["fft"] == pytest.approx(ref["fft"], rel=1e-9)
    f = lambda x, k: F.conv2d(x, k, padding=1)
    cats = flops_by_category(f, torch.zeros(1, 3, 8, 8),
                             torch.zeros(4, 3, 3, 3))
    assert cats.get("conv", 0) == pytest.approx(2 * 4 * 8 * 8 * 3 * 9)


@pytest.mark.parametrize("case", ["ifft2", "rfft", "irfft", "fft_batched"])
def test_flops_fft_variants_match_reference(case):
    x = _t((6, 64), seed=1)
    fns = {"ifft2": (lambda a: torch.fft.ifft2(a.to(torch.complex64)),
                     lambda a: jnp.fft.ifft2(a.astype(jnp.complex64))),
           "rfft": (torch.fft.rfft, jnp.fft.rfft),
           "irfft": (lambda a: torch.fft.irfft(torch.fft.rfft(a), n=64),
                     lambda a: jnp.fft.irfft(jnp.fft.rfft(a), n=64)),
           "fft_batched": (torch.fft.fft, jnp.fft.fft)}
    tf, jf = fns[case]
    cats = flops_by_category(tf, x)
    ref = jprof.flops_by_category(jf, jnp.asarray(x.numpy()))
    assert cats["fft"] == pytest.approx(ref["fft"], rel=1e-9)


@pytest.mark.parametrize("groups,stride,dims", [(1, 1, 2), (2, 2, 2),
                                                (1, 3, 1), (4, 1, 1)])
def test_flops_conv_matches_reference(groups, stride, dims):
    cin, cout = 8, 12
    shape = (2, cin) + (20,) * dims
    kshape = (cout, cin // groups) + (3,) * dims
    x, w = _t(shape, 2), _t(kshape, 3)
    conv = F.conv2d if dims == 2 else F.conv1d
    cats = flops_by_category(
        lambda a, b: conv(a, b, stride=stride, groups=groups), x, w)
    ref = jprof.flops_by_category(
        lambda a, b: jax.lax.conv_general_dilated(
            a, b, (stride,) * dims, "VALID", feature_group_count=groups),
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    assert cats["conv"] == pytest.approx(ref["conv"], rel=1e-9)


@pytest.mark.parametrize("op", ["bmm", "addmm", "baddbmm", "einsum",
                                "linear", "batched_matmul"])
def test_flops_matmul_forms_match_reference(op):
    a, b, bias = _t((3, 8, 16), 4), _t((3, 16, 5), 5), _t((5,), 6)
    fns = {"bmm": (torch.bmm, jnp.matmul, (a, b)),
           "addmm": (lambda x, y, c: torch.addmm(c, x, y),
                     lambda x, y, c: x @ y + c, (a[0], b[0], bias)),
           "baddbmm": (lambda x, y, c: torch.baddbmm(c, x, y),
                       lambda x, y, c: x @ y + c, (a, b, bias)),
           "einsum": (lambda x, y: torch.einsum("bij,bjk->bik", x, y),
                      lambda x, y: jnp.einsum("bij,bjk->bik", x, y), (a, b)),
           "linear": (lambda x, y: F.linear(x, y[0].T),
                      lambda x, y: x @ y[0], (a, b)),
           "batched_matmul": (lambda x, y: x @ y[0], lambda x, y: x @ y[0],
                              (a, b))}
    tf, jf, args = fns[op]
    cats = flops_by_category(tf, *args)
    ref = jprof.flops_by_category(jf, *[jnp.asarray(t.numpy())
                                        for t in args])
    assert cats["matmul"] == pytest.approx(ref["matmul"], rel=1e-9)


def test_flops_sdpa_counts_its_two_products():
    q, k, v = _t((2, 4, 32, 16), 7), _t((2, 4, 40, 16), 8), \
        _t((2, 4, 40, 16), 9)
    fused = flops_by_category(F.scaled_dot_product_attention, q, k, v)
    dense = flops_by_category(
        lambda q, k, v: torch.softmax(q @ k.transpose(-1, -2), -1) @ v,
        q, k, v)
    assert fused["matmul"] == dense["matmul"] == 4 * 2 * 4 * 32 * 40 * 16


def test_views_count_nothing():
    x = torch.zeros(8, 16)
    cats = flops_by_category(
        lambda a: a.reshape(16, 8).T.unsqueeze(0).expand(3, 8, 16)[1], x)
    assert cats == {}
    assert traffic_bytes(lambda a: a.view(128).transpose(0, 0), x) == 0.0


def test_flops_branch_counts_the_side_taken():
    def f(x, big):
        return x @ x if big else x + 1.0
    x = torch.zeros(4, 4)
    assert flops_by_category(f, x, True) == {"matmul": 2 * 4 ** 3}
    assert flops_by_category(f, x, False) == {"other": 16.0}


# --- traffic_bytes ------------------------------------------------------------------

def test_traffic_bytes_matmul_matches_reference():
    got = traffic_bytes(lambda a, b: a @ b, torch.zeros(8, 16),
                        torch.zeros(16, 32))
    want = jprof.traffic_bytes(lambda a, b: a @ b, jnp.zeros((8, 16)),
                               jnp.zeros((16, 32)))
    assert got == want == 4 * (8 * 16 + 16 * 32 + 8 * 32)


def test_traffic_bytes_elementwise_chain_matches_reference():
    x = _t((64, 32), 10)
    got = traffic_bytes(lambda a: torch.exp(a) * 2.0 + a, x)
    want = jprof.traffic_bytes(lambda a: jnp.exp(a) * 2.0 + a,
                               jnp.asarray(x.numpy()))
    assert got == want == 4 * 64 * 32 * (2 + 2 + 3)


# --- the kernel wrappers' charges ---------------------------------------------------

def test_dft_stages_charge_what_the_reference_walk_gives():
    rng = np.random.default_rng(11)
    a = rng.random((3, 32, 48), dtype=np.float32)
    wr, wi = [np.asarray(t) for t in jdft.dft_matrix_factors(32)]
    vr, vi = [np.asarray(t) for t in jdft.dft_matrix_factors(48)]
    ref1 = jprof.flops_by_category(
        lambda *x: jdft.dft_stage1_batched(*x, dac_bits=8, bm=32, bk=32,
                                           bn=16), wr, wi, a)
    got1 = flops_by_category(
        lambda *x: optical_dft.dft_stage1_batched(*x, dac_bits=8),
        *map(torch.from_numpy, (wr, wi, a)))
    assert got1 == ref1 == {"other": 2 * 3 * 32 * 48}
    tr, ti = (rng.random((3, 32, 48), dtype=np.float32) for _ in range(2))
    ref2 = jprof.flops_by_category(
        lambda *x: jdft.dft_stage2_batched(*x, bm=32, bk=16, bn=16),
        tr, ti, vr, vi)
    got2 = flops_by_category(optical_dft.dft_stage2_batched,
                             *map(torch.from_numpy, (tr, ti, vr, vi)))
    assert got2 == ref2 == {"other": 3 * 32 * 48}
    # the batch-1 wrappers go through the batched ones: charged once
    got = flops_by_category(
        lambda *x: ops.dft_stage2(*ops.dft_stage1(x[0], x[1], x[2][0]),
                                  x[3], x[4]),
        *map(torch.from_numpy, (wr, wi, a, vr, vi)))
    assert got == {"other": 2 * 32 * 48 + 32 * 48}


def test_converter_boundary_charges_its_output():
    x = torch.rand(64, 96, generator=torch.Generator().manual_seed(0))
    got = flops_by_category(adc_dac.converter_boundary, x)
    assert got == {"other": 64 * 96}
    ref = jprof.flops_by_category(
        lambda a: jadc.converter_boundary(a, block_rows=16),
        jnp.asarray(x.numpy()))
    # the reference's walk also counts its jnp auto-range around the call
    assert ref["other"] >= got["other"]
    assert traffic_bytes(adc_dac.converter_boundary, x) == 2 * 4 * 64 * 96


@pytest.mark.parametrize("dtype,window,groups", [
    (torch.float32, 0, 1), (torch.bfloat16, 0, 2), (torch.float32, 8, 4)])
def test_flash_attention_charges_the_reference_chunked_matmuls(
        dtype, window, groups):
    b, s, hkv, hd = 2, 32, 2, 16
    h = hkv * groups
    q = _t((b, h, s, hd), 12).to(dtype)
    k, v = _t((b, hkv, s, hd), 13).to(dtype), _t((b, hkv, s, hd), 14).to(dtype)
    got = flops_by_category(
        lambda *x: ops.gqa_flash_attention(*x, window=window), q, k, v)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jprof.flops_by_category(
        lambda *x: _sdpa_chunked(*x, causal=True, window=window, q_pos0=0,
                                 k_pos0=0),
        jax.ShapeDtypeStruct((b, s, h, hd), jdt),
        jax.ShapeDtypeStruct((b, s, hkv, hd), jdt),
        jax.ShapeDtypeStruct((b, s, hkv, hd), jdt))
    assert got["matmul"] == ref["matmul"] == 4 * b * h * s * s * hd
    # the hook pauses the count inside: the plain body's bmm is not seen
    plain = flops_by_category(
        lambda *x: local_attention.local_flash_attention_plain(
            *x, window=window, kv_groups=groups),
        q.reshape(b * h, s, hd), k.reshape(b * hkv, s, hd),
        v.reshape(b * hkv, s, hd))
    assert plain["matmul"] == got["matmul"]


def test_charged_wrappers_keep_results_and_counts():
    """Under the counting mode a wrapper returns what it returns without
    it, on the CPU through its plain version; a nested charged call is
    charged once."""
    q = _t((4, 16, 8), 15)
    k, v = _t((2, 16, 8), 16), _t((2, 16, 8), 17)
    want = ops.local_flash_attention(q, k, v, kv_groups=2)
    seen = {}

    def f(q, k, v):
        seen["out"] = ops.local_flash_attention(q, k, v, kv_groups=2)
        return seen["out"]
    cats = flops_by_category(f, q, k, v)
    assert torch.equal(seen["out"], want)
    assert cats["matmul"] == 4 * 4 * 16 * 16 * 8
    assert cats["other"] == 5 * 4 * 16 * 16 + 4 * 16 * 8


# --- LM losses against the reference ----------------------------------------------

def _lm_pair(arch):
    jcfg, tcfg = jcfgs.get_smoke_config(arch), tcfgs.get_smoke_config(arch)
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                              device="cpu")
    rng = np.random.default_rng(3)
    b, s = 2, 32                            # the planner's trace shape
    tok, lab = (rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
                for _ in range(2))
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tb = {"tokens": torch.from_numpy(tok).long(),
          "labels": torch.from_numpy(lab).long()}
    # the planner's frames (b, s // 2, d) and patches, as float32 inputs
    extra = {}
    if tcfg.is_encdec:
        extra["frames"] = (b, s // 2, tcfg.d_model)
    if tcfg.frontend == "vision":
        extra["patches"] = (b, tcfg.frontend_tokens, tcfg.d_model)
    for k, shape in extra.items():
        x = rng.standard_normal(shape).astype(np.float32)
        jb[k], tb[k] = jnp.asarray(x), torch.from_numpy(x)
    return (JLM(jcfg), jp, jb), (LM(tcfg), tp, tb)


@pytest.fixture(scope="module", params=ARCHS)
def lm_counts(request):
    (jm, jp, jb), (tm, tp, tb) = _lm_pair(request.param)
    ref = jprof.flops_by_category(lambda p, bb: jm.loss(p, bb)[0], jp, jb)
    loss = lambda p, bb: tm.loss(p, bb)[0]
    cpu = flops_by_category(loss, tp, tb)
    meta = flops_by_category(
        loss, map_tree(lambda t: torch.empty_like(t, device="meta"), tp),
        {k: torch.empty_like(v, device="meta") for k, v in tb.items()})
    return request.param, ref, cpu, meta


def test_lm_loss_offloadable_flops_match_reference(lm_counts):
    _, ref, cpu, _ = lm_counts
    got, want = _offloadable(cpu), _offloadable(ref)
    assert got["matmul"] > 0
    for cat in got:
        assert got[cat] == pytest.approx(want[cat], rel=1e-9, abs=0.0)


def test_lm_loss_counts_equal_on_meta_and_cpu(lm_counts):
    _, _, cpu, meta = lm_counts
    assert meta == cpu


def test_lm_loss_other_within_band_of_reference(lm_counts):
    _, ref, cpu, _ = lm_counts
    ratio = cpu["other"] / ref["other"]
    assert OTHER_BAND[0] <= ratio <= OTHER_BAND[1], ratio


# --- OpProfiler -----------------------------------------------------------------------

def test_op_profiler_counts_tensor_leaves_only():
    prof = OpProfiler()
    prof.start()
    out = prof.run("fft", lambda x, scale, d: (torch.fft.fft2(x) * scale,
                                                d["w"]),
                   torch.zeros(8, 8), 2.0, {"w": torch.ones(3)})
    with prof.op("conv", n_in=5, n_out=7):
        pass
    total = prof.stop()
    assert out[0].shape == (8, 8)
    assert prof.calls == {"fft": 1, "conv": 1}
    assert prof.samples_in == {"fft": 64 + 3, "conv": 5}
    assert prof.samples_out == {"fft": 64 + 3, "conv": 7}
    assert prof.total_s == total > 0.0
    assert 0.0 < prof.fraction() <= 1.0
    assert prof.accelerable_s() == prof.seconds["fft"] + prof.seconds["conv"]
    with pytest.raises(RuntimeError):
        prof.stop()


def test_op_profiler_counts_like_the_reference():
    x = np.random.default_rng(5).random((16, 12), dtype=np.float32)
    jp, tp = jprof.OpProfiler(), OpProfiler()
    jp.run("conv", lambda a, s: (a * s, [a, a]), jnp.asarray(x), 3.0)
    tp.run("conv", lambda a, s: (a * s, [a, a]), torch.from_numpy(x), 3.0)
    assert (tp.calls, tp.samples_in, tp.samples_out) == \
        (jp.calls, jp.samples_in, jp.samples_out)
    assert tp.fraction() == jp.fraction() == 0.0


# --- complexity (Fig. 3) ----------------------------------------------------------

@pytest.mark.parametrize("name", list(jcomplexity.PROBLEM_CLASSES))
@pytest.mark.parametrize("threshold", [1.0, 10.0])
def test_complexity_crossover_matches_reference(name, threshold):
    assert complexity.crossover_n(name, threshold) == \
        jcomplexity.crossover_n(name, threshold)


@pytest.mark.parametrize("name", list(jcomplexity.PROBLEM_CLASSES))
def test_complexity_advantage_matches_reference(name):
    for n in (1.0, 3.0, 64.0, 1e3, 2.0 ** 20, 1e6):
        assert complexity.advantage(name, n) == jcomplexity.advantage(name, n)


def test_linear_class_never_crosses():
    assert complexity.crossover_n("elementwise O(N)", 1.0) is None


def test_superlinear_classes_cross():
    for name in ("fft O(N log N)", "matvec O(N^2)", "ising O(2^N)"):
        assert complexity.crossover_n(name, 1.0) is not None


@pytest.mark.parametrize("n", [4.0, 17.5, 1e3, 123456.0, 1e6])
def test_matvec_advantage_grows(n):
    assert complexity.advantage("matvec O(N^2)", 2 * n) > \
        complexity.advantage("matvec O(N^2)", n)


def test_complexity_rejects_bad_input():
    with pytest.raises(KeyError):
        complexity.advantage("nope", 4.0)
    with pytest.raises(ValueError):
        complexity.advantage("matvec O(N^2)", 0.0)


# --- the telemetry -> plan loop -------------------------------------------------------

def test_telemetry_profiles_reproduce_hand_profiled_plan():
    """Executing through the runtime's host backend must yield profiles
    whose plan matches a hand ``OpProfiler`` run of the same frames.

    Both loops are warmed before they are timed, and both run at one
    intra-op thread: a 64x64 ``fft2`` opens a parallel region over every
    thread, and on a loaded machine waiting for them took 150-280 ms for
    the six calls (against ~0.5 ms at one thread), near the prototype's
    0.29 s offload price, so either plan's fft decision could flip."""
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.random((64, 64), dtype=np.float32))
            for _ in range(6)]

    def host_fft(x):
        return torch.fft.fft2(x, norm="ortho").abs() ** 2

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _hand_and_telemetry_plans_agree(imgs, host_fft)
    finally:
        torch.set_num_threads(threads)


def _hand_and_telemetry_plans_agree(imgs, host_fft):
    for im in imgs:
        host_fft(im)
    prof = OpProfiler()
    prof.start()
    for im in imgs:
        prof.run("fft", host_fft, im)
    prof.stop()
    hand = [CategoryProfile("fft", host_s=prof.seconds["fft"],
                            calls=prof.calls["fft"],
                            samples_in=prof.samples_in["fft"],
                            samples_out=prof.samples_out["fft"]),
            CategoryProfile("other",
                            host_s=prof.total_s - prof.seconds["fft"])]
    hand_plan = plan_offload(hand, PROTOTYPE_4F)

    ex = trt.OffloadExecutor(PROTOTYPE_4F, default_backend="host",
                             device="cpu")
    for im in imgs:
        ex.warm("fft", im)
    ex.telemetry.start()
    for im in imgs:
        ex.run("fft", im)
    ex.telemetry.stop()
    measured_plan = plan_offload(ex.telemetry.profiles(), PROTOTYPE_4F)

    by_name = {p.name: p for p in ex.telemetry.profiles()}
    assert by_name["fft"].calls == hand[0].calls
    assert by_name["fft"].samples_in == hand[0].samples_in
    assert by_name["fft"].samples_out == hand[0].samples_out
    hand_d = {d.category: d.offload for d in hand_plan.decisions}
    measured_d = {d.category: d.offload for d in measured_plan.decisions}
    assert hand_d == measured_d
    assert measured_d["fft"] is False
