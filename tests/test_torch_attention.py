"""The port's flash attention on the CPU, against the reference's kernel.

The reference's Pallas kernel (``repro.kernels.ops.local_flash_attention``
and ``gqa_flash_attention``) runs in interpret mode, as its own tests run
it on the CPU; the port's wrappers take their plain version for CPU
tensors.  Inputs are made with numpy from a seed and handed to both.
Bounds are the reference's (``tests/test_kernels.py``): rtol/atol 2e-5 in
float32, 3e-2 in bfloat16.  The grid is the reference test's, (lq, lk, d)
in {(128,128,64), (256,128,32), (128,256,64)} x {causal, causal + window
64, non-causal}, at kv_groups 2 and 4, plus ragged lengths (77, 200) that
no 64-block divides, and head dims 48, 192 and 256 beside them.  Causal
cases with lq > lk, which the reference test skips, are included: both
sides mask by index (query i sees keys <= i), so they compute the same
function there too, including the rows that a window leaves with no key
at all (both give 0 there).

The port's attention is differentiable (training runs through it): on
the CPU its gradients are the plain version's autograd, held to
``jax.grad`` of the reference's dense oracle ``ref.local_attention_ref``
in float32 at rtol 2e-5 / atol 2e-5 * max|g| (summation order only), at
causal, windowed and GQA cases where every query sees a key (the oracle
averages uniformly over a row that sees none; the kernel gives 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import local_attention as tla
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import attention as tattn

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
MODES = [(True, 0), (True, 64), (False, 0)]


def _qkv(bh, lq, lk, d, groups, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, lq, d)).astype(np.float32),
            rng.standard_normal((bh // groups, lk, d)).astype(np.float32),
            rng.standard_normal((bh // groups, lk, d)).astype(np.float32))


def _both(q, k, v, dtype, **kw):
    """(reference kernel, port wrapper) on the same inputs, as float32."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jops.local_flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), block_q=64, block_k=64,
        **kw)
    got = tla.local_flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **kw)
    assert got.dtype == tdt
    return np.asarray(want, np.float32), got.to(torch.float32).numpy()


@pytest.mark.parametrize("lq,lk,d", [(128, 128, 64), (256, 128, 32),
                                     (128, 256, 64)])
@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("groups", [2, 4])
def test_plain_matches_reference_kernel_f32(lq, lk, d, causal, window,
                                            groups):
    q, k, v = _qkv(8, lq, lk, d, groups)
    want, got = _both(q, k, v, "float32", causal=causal, window=window,
                      kv_groups=groups)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("lq,lk", [(77, 77), (200, 200), (77, 200),
                                   (200, 77)])
@pytest.mark.parametrize("causal,window", MODES)
def test_plain_matches_reference_kernel_ragged(lq, lk, causal, window):
    q, k, v = _qkv(4, lq, lk, 32, 2, seed=1)
    want, got = _both(q, k, v, "float32", causal=causal, window=window,
                      kv_groups=2)
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("lq,lk,groups", [(128, 128, 1), (200, 200, 2),
                                          (77, 128, 4)])
@pytest.mark.parametrize("causal,window", MODES)
def test_plain_matches_reference_kernel_bf16(lq, lk, groups, causal, window):
    q, k, v = _qkv(4, lq, lk, 64, groups, seed=2)
    want, got = _both(q, k, v, "bfloat16", causal=causal, window=window,
                      kv_groups=groups)
    np.testing.assert_allclose(got, want, **BF16)


# every head dim the reference's kernel takes, not only the powers of two
# the card's tensor cores like: 48 (the FMA route's bucket of 64 with 16
# columns masked), 192 (nemotron-4-340b) and 256 (recurrentgemma)
@pytest.mark.parametrize("d", [48, 192, 256])
@pytest.mark.parametrize("causal,window", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel_at_any_head_dim(d, causal, window,
                                                        dtype):
    q, k, v = _qkv(4, 128, 128, d, 2, seed=4)
    want, got = _both(q, k, v, dtype, causal=causal, window=window,
                      kv_groups=2)
    np.testing.assert_allclose(got, want,
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("hq,hkv,l", [(8, 2, 128), (8, 8, 77), (4, 1, 200)])
def test_gqa_4d_wrapper_matches_reference(hq, hkv, l):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, hq, l, 32)).astype(np.float32)
    k = rng.standard_normal((2, hkv, l, 32)).astype(np.float32)
    v = rng.standard_normal((2, hkv, l, 32)).astype(np.float32)
    want = jops.gqa_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, block_q=64,
                                    block_k=64)
    got = tops.gqa_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("causal,window", MODES)
def test_oracles_agree(causal, window):
    q, k, v = _qkv(8, 96, 96, 16, 4, seed=4)
    want = jref.local_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window, kv_groups=4)
    got = tref.local_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   window=window, kv_groups=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("h,hkv,window", [(4, 4, 0), (8, 1, 0), (8, 2, 5)])
def test_sdpa_chunked_matches_reference(h, hkv, window):
    """The plain version in the model's (B, S, H, hd) layout against the
    reference's chunked jnp path (positions aligned at 0)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 40, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, hkv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, hkv, 16)).astype(np.float32)
    want = jattn._sdpa_chunked(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=True, window=window,
                               q_pos0=0, k_pos0=0, q_chunk=8)
    got = tattn._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("h,hkv,d,dv", [(4, 4, 12, 8), (8, 2, 24, 16),
                                        (4, 4, 192, 128)])
def test_narrower_v_matches_reference_sdpa_chunked(h, hkv, d, dv):
    """V narrower than q and k (MLA's 128 against 192): the port's 4-D
    wrapper, as ``mla_full`` calls it (its default scale ``d ** -0.5`` is
    MLA's ``qk_head_dim ** -0.5``), against the reference's chunked path
    in float32, the output and the gradients of q, k and v
    (``jax.vjp``)."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 40, h, d)).astype(np.float32)
    k = rng.standard_normal((2, 40, hkv, d)).astype(np.float32)
    v = rng.standard_normal((2, 40, hkv, dv)).astype(np.float32)
    dout = rng.standard_normal((2, 40, h, dv)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: jattn._sdpa_chunked(
        *a, causal=True, window=0, q_pos0=0, k_pos0=0, q_chunk=8,
        softmax_scale=d ** -0.5), *(jnp.asarray(a) for a in (q, k, v)))
    want_g = vjp(jnp.asarray(dout))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = tops.gqa_flash_attention(
        *(t.transpose(1, 2) for t in ts)).transpose(1, 2)
    assert got.shape == (2, 40, h, dv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    got.backward(torch.from_numpy(dout))
    for name, t, w in zip("qkv", ts, want_g):
        w = np.asarray(w)
        assert t.grad.shape == w.shape, name
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=2e-5,
                                   atol=2e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def test_wrapper_rejects_v_wider_than_q():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 64, 64, 16, 2))
    with pytest.raises(ValueError, match="Dv <= D"):
        tla.local_flash_attention(q, k, torch.cat([v, v], dim=-1),
                                  kv_groups=2)


def test_cpu_tensors_take_the_plain_version_without_counting():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 64, 64, 16, 2))
    tla.reset_launches()
    got = tla.local_flash_attention(q, k, v, kv_groups=2)
    assert tla.local_flash_attention.launches == 0
    torch.testing.assert_close(
        got, tla.local_flash_attention_plain(q, k, v, kv_groups=2),
        rtol=0, atol=0)


def test_wrapper_rejects_bad_operands():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 64, 64, 16, 2))
    with pytest.raises(ValueError, match="kv_groups"):
        tla.local_flash_attention(q, k, v, kv_groups=3)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        tla.local_flash_attention(q, k.to("meta"), v.to("meta"),
                                  kv_groups=2)
    with pytest.raises(ValueError, match="no keys"):
        tla.local_flash_attention(q, k[:, :0], v[:, :0], kv_groups=2)
    with pytest.raises(ValueError, match="group"):
        tops.gqa_flash_attention(q[None, :3], k[None], v[None])


def test_wrapper_takes_meta_operands_shape_only():
    """On the meta device (a FLOP count of shapes alone) the wrapper runs
    its plain version, which computes shapes only."""
    q, k, v = (torch.from_numpy(a).to("meta") for a in _qkv(4, 64, 48, 16, 2))
    out = tla.local_flash_attention(q, k, v, kv_groups=2)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == q.dtype


@pytest.mark.parametrize("lq,lk,d,groups,causal,window", [
    (128, 128, 64, 1, True, 0), (77, 77, 32, 2, True, 0),
    (128, 128, 16, 4, True, 24), (96, 128, 32, 2, False, 0),
    (64, 200, 16, 1, False, 40), (200, 200, 64, 2, True, 64),
    (128, 128, 192, 2, True, 0), (77, 77, 192, 1, True, 32),
    (96, 96, 192, 4, False, 0)])
def test_gradients_match_reference_oracle(lq, lk, d, groups, causal, window):
    q, k, v = _qkv(8, lq, lk, d, groups, seed=5)
    dout = np.random.default_rng(6).standard_normal(q.shape).astype(
        np.float32)
    kw = dict(causal=causal, window=window, kv_groups=groups)
    _, vjp = jax.vjp(lambda *a: jref.local_attention_ref(*a, **kw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tla.local_flash_attention(*ts, **kw).backward(torch.from_numpy(dout))
    for name, t, w in zip(("dq", "dk", "dv"), ts, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=2e-5,
                                   atol=2e-5 * float(np.abs(w).max()),
                                   err_msg=name)


def test_gqa_wrapper_gradients_reach_q_k_v():
    """Through the 4-D wrapper ``gqa_flash_attention`` (what the model
    calls), the gradients are the 3-D kernel's, reshaped."""
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((2, 4, 50, 16)).astype(
        np.float32)).requires_grad_()
    k = torch.from_numpy(rng.standard_normal((2, 2, 50, 16)).astype(
        np.float32)).requires_grad_()
    v = torch.from_numpy(rng.standard_normal((2, 2, 50, 16)).astype(
        np.float32)).requires_grad_()
    tops.gqa_flash_attention(q, k, v, window=20).square().sum().backward()
    q3, k3, v3 = (t.detach().reshape(-1, 50, 16).requires_grad_()
                  for t in (q, k, v))
    tla.local_flash_attention(q3, k3, v3, window=20, kv_groups=2
                              ).square().sum().backward()
    for t, t3 in ((q, q3), (k, k3), (v, v3)):
        torch.testing.assert_close(t.grad.reshape(t3.shape), t3.grad,
                                   rtol=0, atol=0)


# --- the CUDA kernel's tensor-core route, emulated on the CPU ---------------
#
# On the card, bfloat16 q, k, v at head dims 64, 128, 192 and 256 take the
# tensor-core route (``tla.route``): S = Q K^T from bf16 operands into fp32
# (exact products), an online softmax over 64-key tiles in fp32, and the
# second products (P V; dS K, dS^T Q, P^T dO) with their 16-bit operand
# split into hi = bf16(x) and lo = bf16(x - hi), two bf16 products into one
# fp32 accumulator.  The emulation below computes exactly that arithmetic
# in plain PyTorch (summation order aside), so that a precision mistake
# in the design shows here, against the reference, before any card run.
# It is held to the bounds that chip_smoke.py holds the kernel to: the
# bf16 forward at rtol 1e-2 / atol 1e-3 against the fp32 reference output
# rounded to bf16, the bf16 gradients within 2e-2 * max|reference|.

TC_TILE = 64


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = _bf16(x)
    return hi, _bf16(x - hi)


def _split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a split hi/lo and b already bf16, fp32 accumulation."""
    hi, lo = _split(a)
    return hi @ b + lo @ b


def _tc_forward(q, k, v, *, causal, window, kv_groups):
    """(out in bf16, lse) as the tensor-core forward computes them."""
    bh, lq, d = q.shape
    scale = d ** -0.5
    kk = k.repeat_interleave(kv_groups, 0)
    vv = v.repeat_interleave(kv_groups, 0)
    mask = tla._mask(lq, k.shape[1], causal, window, q.device)
    o = torch.zeros((bh, lq, d))
    m = torch.full((bh, lq, 1), -1.0e30)
    l = torch.zeros((bh, lq, 1))
    for k0 in range(0, k.shape[1], TC_TILE):
        ok = mask[:, k0:k0 + TC_TILE]
        s = torch.where(ok, q @ kk[:, k0:k0 + TC_TILE].transpose(1, 2) * scale,
                        -1.0e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _split_mm(p, vv[:, k0:k0 + TC_TILE])
        m = m_new
    out = _bf16(o / torch.clamp(l, min=1e-20))
    return out, (m + torch.log(torch.clamp(l, min=1e-20)))[..., 0]


def _tc_backward(q, k, v, out, lse, dout, *, causal, window, kv_groups):
    """(dq, dk, dv) in bf16 as the tensor-core backward computes them."""
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    scale = d ** -0.5
    kk = k.repeat_interleave(kv_groups, 0)
    vv = v.repeat_interleave(kv_groups, 0)
    mask = tla._mask(lq, lk, causal, window, q.device)
    delta = (dout * out).sum(-1, keepdim=True)
    s = q @ kk.transpose(1, 2)
    p = torch.where(mask, torch.exp(s * scale - lse[..., None]), 0.0)
    ds = p * (dout @ vv.transpose(1, 2) - delta)
    dq = scale * _split_mm(ds, kk)
    dk = scale * _split_mm(ds.transpose(1, 2), q)
    dv = _split_mm(p.transpose(1, 2), dout)
    fold = lambda g: g.reshape(bhkv, kv_groups, lk, d).sum(1)
    return _bf16(dq), _bf16(fold(dk)), _bf16(fold(dv))


# (bh, lq, lk, d, kv_groups, causal, window): D 64, 128, 192 and 256,
# ragged L, GQA, a window and non-causal; every query sees a key (the
# reference oracle averages uniformly over a row that sees none).
TC_CASES = [(4, 77, 77, 64, 1, True, 0), (4, 200, 200, 128, 4, True, 64),
            (8, 128, 128, 64, 4, False, 0), (4, 77, 200, 128, 2, False, 64),
            (4, 200, 77, 64, 1, True, 0), (12, 200, 200, 192, 12, True, 0),
            (4, 77, 77, 192, 2, False, 64), (4, 130, 130, 256, 4, True, 0),
            (2, 77, 200, 256, 1, False, 0)]


def _bf16_inputs(bh, lq, lk, d, groups, seed):
    """q, k, v and dout drawn from a seed and rounded to bf16, as float32."""
    q, k, v = (_bf16(torch.from_numpy(a))
               for a in _qkv(bh, lq, lk, d, groups, seed=seed))
    dout = _bf16(torch.from_numpy(np.random.default_rng(seed + 1)
                                  .standard_normal(q.shape)
                                  .astype(np.float32)))
    return q, k, v, dout


@pytest.mark.parametrize("bh,lq,lk,d,groups,causal,window", TC_CASES)
def test_tensor_core_forward_design_matches_reference_kernel(
        bh, lq, lk, d, groups, causal, window):
    q, k, v, _ = _bf16_inputs(bh, lq, lk, d, groups, seed=20)
    kw = dict(causal=causal, window=window, kv_groups=groups)
    want = jops.local_flash_attention(
        *(jnp.asarray(t.numpy()) for t in (q, k, v)), block_q=64,
        block_k=64, **kw)
    want = _bf16(torch.from_numpy(np.array(want)))
    got, _ = _tc_forward(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("bh,lq,lk,d,groups,causal,window", TC_CASES)
def test_tensor_core_backward_design_matches_reference_grads(
        bh, lq, lk, d, groups, causal, window):
    q, k, v, dout = _bf16_inputs(bh, lq, lk, d, groups, seed=21)
    kw = dict(causal=causal, window=window, kv_groups=groups)
    _, vjp = jax.vjp(lambda *a: jref.local_attention_ref(*a, **kw),
                     *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(dout.numpy()))
    out, lse = _tc_forward(q, k, v, **kw)
    got = _tc_backward(q, k, v, out, lse, dout, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = torch.from_numpy(np.array(w))
        top = float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=0, atol=2e-2 * top, msg=name)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "tensor_core"), (torch.bfloat16, 128, "tensor_core"),
    (torch.bfloat16, 192, "tensor_core"), (torch.bfloat16, 256, "tensor_core"),
    (torch.bfloat16, 8, "fma"), (torch.bfloat16, 16, "fma"),
    (torch.bfloat16, 32, "fma"), (torch.bfloat16, 48, "fma"),
    (torch.bfloat16, 160, "fma"), (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"), (torch.float32, 8, "fma"),
    (torch.float32, 192, "fma"), (torch.float16, 128, "fma"),
    (torch.float16, 256, "fma")])
def test_route_follows_dtype_and_head_dim(dtype, d, want):
    assert tla.route(dtype, d) == want
