"""The port's DFT kernels' plain versions against the reference's kernels.

The reference's Pallas kernels run in interpret mode on the CPU, exactly
as ``tests/test_kernels.py`` runs them; the port's wrappers take their
plain PyTorch versions for CPU tensors.  Inputs are made with numpy from a
seed and fed to both.  The shapes and bounds are those of
``tests/test_kernels.py``: stage 1 rtol 1e-4 / atol 1e-5, stage 2 rtol
1e-4 / atol 1e-4, the whole pipeline rtol 2e-4 / atol 2e-4*max, batched
against looped rtol 1e-5.  Both pipelines are held to the fft2 oracle:
the reference's float32 factor phase drifts by ~1e-4 rad at n = 512, the
port's does not, so the port is not held to a copy of that error.

The converter boundary is held at ``tests/test_kernels.py``'s cases and
bounds: 4 shapes x 3 (dac, adc) bit pairs with noise 0.02 at rtol 1e-6 /
atol 1.5 ADC steps (fp association order can flip a round-to-nearest tie
by one step), and float32 / bfloat16 in and out at 1e-2.

NaN, infinities and all-negative inputs: the plain converter boundary
and the DFT stages' DAC are held to ``repro.kernels.ref`` bit for bit
(NaN in the same places), and to the reference's Pallas kernels at the
bounds above with the same NaNs.

The kernels themselves are held to these versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import adc_dac
from repro_torch.kernels import optical_dft as od
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape", [(128, 128), (256, 128), (128, 384),
                                   (8, 128), (256, 256)])
@pytest.mark.parametrize("dac_bits", [0, 6, 8])
def test_optical_dft_intensity_matches_reference(shape, dac_bits):
    aj, at = _both(_rand(1, shape))
    got = tops.optical_dft2_intensity(at, dac_bits=dac_bits).numpy()
    want = np.asarray(jref.optical_dft2_intensity_ref(aj, dac_bits=dac_bits))
    _close(got, want, 2e-4, 2e-4 * float(want.max()))
    kern = np.asarray(jops.optical_dft2_intensity(aj, dac_bits=dac_bits))
    _close(got, kern, 2e-4, 2e-4 * float(kern.max()))


def _factors_rows(k, m):
    """The reference's W (m, k): its unitary factors, rows tiled to m."""
    wr, wi = (np.asarray(w) for w in jops.dft_matrix_factors(k))
    reps = -(-m // k)
    return np.tile(wr, (reps, 1))[:m], np.tile(wi, (reps, 1))[:m]


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 128, 384),
                                   (8, 256, 128)])
def test_dft_stage1_matches_reference(m, k, n):
    wr, wi = _factors_rows(k, m)
    a = _rand(2, (k, n))
    tr, ti = tops.dft_stage1(*map(torch.from_numpy, (wr, wi, a)), dac_bits=8)
    rr, ri = jops.dft_stage1(jnp.asarray(wr), jnp.asarray(wi),
                             jnp.asarray(a), dac_bits=8)
    _close(tr, rr, 1e-4, 1e-5)
    _close(ti, ri, 1e-4, 1e-5)
    pr, pi = tref.dft_stage1_ref(*map(torch.from_numpy, (wr, wi, a)),
                                 dac_bits=8)
    _close(tr, pr, 1e-4, 1e-5)
    _close(ti, pi, 1e-4, 1e-5)


def test_dft_stage2_matches_reference():
    tr, ti = _rand(3, (128, 256)), _rand(4, (128, 256))
    wr, wi = _factors_rows(256, 128)
    got = tops.dft_stage2(*map(torch.from_numpy, (tr, ti, wr, wi)))
    want = jops.dft_stage2(*map(jnp.asarray, (tr, ti, wr, wi)))
    _close(got, want, 1e-4, 1e-4)
    _close(got, tref.dft_stage2_ref(*map(torch.from_numpy,
                                         (tr, ti, wr, wi))), 1e-4, 1e-4)


@pytest.mark.parametrize("batch,shape", [(1, (128, 128)), (3, (128, 256)),
                                         (5, (64, 64))])
def test_dft_batched_stages_match_looped_and_reference(batch, shape):
    h, w = shape
    a = _rand(11, (batch, h, w))
    whr, whi = od.dft_matrix_factors(h)
    wwr, wwi = od.dft_matrix_factors(w)
    at = torch.from_numpy(a)
    tr, ti = tops.dft_stage1_batched(whr, whi, at, dac_bits=8)
    out = tops.dft_stage2_batched(tr, ti, wwr, wwi)
    for i in range(batch):
        tr1, ti1 = tops.dft_stage1(whr, whi, at[i], dac_bits=8)
        _close(tr[i], tr1, 1e-5, 1e-6)
        _close(ti[i], ti1, 1e-5, 1e-6)
        one = tops.dft_stage2(tr[i], ti[i], wwr, wwi)
        _close(out[i], one, 1e-5, 1e-5 * float(one.max()))
    # the same factors through the reference's batched kernels
    jw = [jnp.asarray(x.numpy()) for x in (whr, whi, wwr, wwi)]
    jtr, jti = jops.dft_stage1_batched(jw[0], jw[1], jnp.asarray(a),
                                       dac_bits=8)
    _close(tr, jtr, 1e-4, 1e-5)
    _close(ti, jti, 1e-4, 1e-5)
    jout = np.asarray(jops.dft_stage2_batched(jtr, jti, jw[2], jw[3]))
    _close(out, jout, 1e-4, 1e-4 * float(jout.max()))


@pytest.mark.parametrize("dac_bits", [0, 8])
def test_optical_dft_batched_pipeline_matches_oracle(dac_bits):
    a = _rand(12, (4, 128, 128))
    got = tops.optical_dft2_intensity_batched(torch.from_numpy(a),
                                              dac_bits=dac_bits).numpy()
    for i in range(4):
        want = np.asarray(jref.optical_dft2_intensity_ref(
            jnp.asarray(a[i]), dac_bits=dac_bits))
        _close(got[i], want, 2e-4, 2e-4 * float(want.max()))
        _close(got[i], tref.optical_dft2_intensity_ref(
            torch.from_numpy(a[i]), dac_bits=dac_bits), 2e-4,
            2e-4 * float(want.max()))


def test_optical_dft_matches_physics_sim():
    """Kernel pipeline == the port's physics model (amplitude encoding)."""
    from repro_torch.core.optical import OpticalSimParams, optical_fft2_magnitude
    a = torch.from_numpy(_rand(5, (128, 128)))
    intensity = tops.optical_dft2_intensity(a, dac_bits=8)
    mag = optical_fft2_magnitude(a, OpticalSimParams(dac_bits=8, adc_bits=16))
    step = float(mag.max() ** 2) / (2 ** 16 - 1)
    _close(intensity, mag ** 2, 1e-3, 2 * step)


@pytest.mark.parametrize("n", [8, 64, 512, 2048])
def test_dft_matrix_factors_match_fft2_oracle(n):
    """The factors are the float32 rounding of the exact unitary DFT
    matrix, which numpy's float64 FFT of the identity gives."""
    wr, wi = od.dft_matrix_factors(n)
    exact = np.fft.fft(np.eye(n), norm="ortho")
    tol = 2.0 ** -24 / np.sqrt(n) * 1.01  # half an ulp of a unit entry
    assert np.abs(wr.numpy() - exact.real).max() <= tol
    assert np.abs(wi.numpy() - exact.imag).max() <= tol
    assert wr.dtype == torch.float32 and wr.shape == (n, n)


def test_cpu_tensors_take_the_plain_version():
    od.reset_launches()
    a = torch.from_numpy(_rand(6, (2, 64, 64)))
    tops.optical_dft2_intensity_batched(a, dac_bits=8)
    assert od.dft_stage1_batched.launches == 0
    assert od.dft_stage2_batched.launches == 0


def test_wrappers_reject_what_the_kernels_do_not_take():
    wr, wi = od.dft_matrix_factors(16)
    a = torch.rand(2, 16, 16)
    with pytest.raises(ValueError):
        od.dft_stage1_batched(wr, wi, a[0])                  # not batched
    with pytest.raises(ValueError):
        od.dft_stage1_batched(wr[:, :8], wi[:, :8], a)      # k mismatch
    with pytest.raises(ValueError):
        od.dft_stage1_batched(wr, wi, a, bm=0)              # bad block
    with pytest.raises(ValueError):
        od.dft_stage1_batched(wr, wi, a, dac_bits=-1)
    with pytest.raises(ValueError):                          # not cpu/cuda
        od.dft_stage2_batched(a.to("meta"), a.to("meta"), wr.to("meta"),
                              wi.to("meta"))


def test_import_and_cpu_path_need_no_nvcc():
    code = ("import sys, torch\n"
            "from repro_torch.kernels import ops\n"
            "ops.optical_dft2_intensity_batched(torch.rand(2, 8, 8))\n"
            "assert 'repro_torch.kernels.build' not in sys.modules\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    env.pop("CUDA_HOME", None)
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)


# --- the DFT kernels' tensor-core route, emulated on the CPU ----------------
#
# On the card, a stage whose k and n are multiples of 4 takes the
# tensor-core route (``od.route``): 3xTF32 on wgmma.  Every fp32 operand x
# (stage 1: dac(A), after the DAC) is split into hi = rna_tf32(x) and
# lo = rna_tf32(x - hi), and lo*hi' + hi*lo' + hi*hi' go into one fp32
# accumulator over a CTA's share of the k steps; the ``od.tc_split``
# CTAs of a cluster then add their partial sums in rank order (stage 2
# squares only the whole sum).  The emulation below computes that
# arithmetic in plain PyTorch (the order of the sums inside each product
# aside), so that a precision mistake in the design shows here, against
# the reference's kernels and the fft2 oracle at their bounds, before any
# card run.


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32 does: on the int32 view, add half of
    the 13 dropped bits' range to the magnitude and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _cluster_sum(stage, m, k, n, part):
    """The partial sums of the cluster's CTAs, ``part(k slice)`` each, added
    in rank order; a CTA past the last k step adds zeros."""
    split = od.tc_split(stage, m, k, n)
    steps = -(-k // od.TC_STEP)
    per = -(-steps // split) * od.TC_STEP
    total = None
    for r in range(split):
        p = part(slice(min(k, r * per), min(k, (r + 1) * per)))
        total = p if total is None else tuple(x + y for x, y in zip(total, p))
    return total


def _tc_stage1(wr, wi, a, dac_bits):
    """T = W @ dac(A) as the tensor-core route computes it."""
    q = a
    if dac_bits:
        levels = torch.tensor(float((1 << dac_bits) - 1))
        q = torch.round(torch.clamp(a, 0.0, 1.0) * levels) / levels
    m, k, n = wr.shape[0], a.shape[1], a.shape[2]
    return _cluster_sum(1, m, k, n, lambda s: (
        _mm_3xtf32(wr[:, s], q[:, s, :]), _mm_3xtf32(wi[:, s], q[:, s, :])))


def _tc_stage2(tr, ti, wr, wi):
    """I = |T @ W^T|^2 as the tensor-core route computes it."""
    m, k, n = tr.shape[1], tr.shape[2], wr.shape[0]
    ur, ui = _cluster_sum(2, m, k, n, lambda s: (
        _mm_3xtf32(tr[..., s], wr[:, s].T) - _mm_3xtf32(ti[..., s],
                                                        wi[:, s].T),
        _mm_3xtf32(tr[..., s], wi[:, s].T) + _mm_3xtf32(ti[..., s],
                                                        wr[:, s].T)))
    return ur * ur + ui * ui


def test_tf32_rounding_is_rna():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      0.1, -3.3e-8])
    got = _tf32(x)
    assert got[0] == 1.0 + 2.0 ** -10           # a tie rounds away from 0
    assert got[1] == 1.0 + 2.0 ** -9
    assert got[2] == -(1.0 + 2.0 ** -10)
    assert got[3] == 1.0                        # below the tie: down
    assert torch.all((got.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((got - x).abs() <= x.abs() * 2.0 ** -11)


def _rn32(x64: np.ndarray, above: np.ndarray) -> np.ndarray:
    """float32 nearest to an exact value that float64 ``x64`` rounds, ties
    to even; where x64 is itself a float32 midpoint, ``above`` (-1, 0, +1)
    says on which side of it the exact value lies.  (Midpoints are float64
    values, so the exact value and its float64 rounding are on one side of
    every other midpoint.)"""
    bits = x64.view(np.uint64)
    mid = (bits & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28)
    out = x64.astype(np.float32)
    up = np.nextafter(out, np.float32(np.inf))
    down = np.nextafter(out, np.float32(-np.inf))
    lo32 = np.where(out.astype(np.float64) > x64, down, out)
    hi32 = np.where(out.astype(np.float64) > x64, out, up)
    return np.where(mid & (above > 0), hi32,
                    np.where(mid & (above < 0), lo32, out))


@pytest.mark.parametrize("bits", range(1, 24))
def test_dac_quotient_is_the_ieee_quotient(bits):
    """The DFT tensor-core route's DAC and the converter boundary's DAC and
    ADC take c / l as d = c * (1 / l) corrected once, fma(fma(-d, l, c),
    1 / l, d) (csrc/optical_dft.cu: dac_fast, csrc/adc_dac.cu: quotient), for
    l = 2^bits - 1 < 2^23: the IEEE quotient for every code c = 0 .. l
    (each one up to 16 bits, a sample of 2^15 and the ends above)."""
    levels = (1 << bits) - 1
    if bits <= 16:
        c = np.arange(levels + 1, dtype=np.float32)
    else:
        rng = np.random.default_rng(bits)
        c = np.concatenate([np.arange(64), levels - np.arange(64),
                            rng.integers(0, levels + 1, 1 << 15)]
                           ).astype(np.float32)
    l = np.float32(levels)
    inv = np.float32(1) / l
    d = c * inv                                            # fp32, RN
    r64 = c.astype(np.float64) - d.astype(np.float64) * levels   # exact
    r = r64.astype(np.float32)
    assert np.array_equal(r.astype(np.float64), r64)       # fma(-d, l, c)
    prod = r.astype(np.float64) * np.float64(inv)          # exact
    s = prod + d.astype(np.float64)                        # TwoSum:
    bb = s - prod                                          # s + err is
    err = (prod - (s - bb)) + (d.astype(np.float64) - bb)  # exact
    got = _rn32(s, np.sign(err))                           # fma(r, inv, d)
    q64 = c.astype(np.float64) / levels
    want = _rn32(q64, np.sign(c.astype(np.float64) - q64 * levels))
    assert np.array_equal(got, want)
    assert np.array_equal(want, c / l)                     # numpy's divide


@pytest.mark.parametrize("batch,m,k,n", [(2, 512, 512, 512), (1, 8, 256, 128),
                                         (3, 128, 128, 256), (5, 64, 64, 64),
                                         (1, 100, 96, 36)])
@pytest.mark.parametrize("dac_bits", [0, 8])
def test_tensor_core_design_matches_reference_kernels(batch, m, k, n,
                                                      dac_bits):
    wr, wi = (torch.from_numpy(w) for w in _factors_rows(k, m))
    a = torch.from_numpy(_rand(13, (batch, k, n)))
    tr, ti = _tc_stage1(wr, wi, a, dac_bits)
    jtr, jti = jops.dft_stage1_batched(jnp.asarray(wr.numpy()),
                                       jnp.asarray(wi.numpy()),
                                       jnp.asarray(a.numpy()),
                                       dac_bits=dac_bits)
    _close(tr, jtr, 1e-4, 1e-5)
    _close(ti, jti, 1e-4, 1e-5)
    w2r, w2i = (torch.from_numpy(w) for w in _factors_rows(n, n))
    got = _tc_stage2(tr, ti, w2r, w2i)
    want = np.asarray(jops.dft_stage2_batched(
        jtr, jti, jnp.asarray(w2r.numpy()), jnp.asarray(w2i.numpy())))
    _close(got, want, 1e-4, 1e-4 * float(want.max()))


@pytest.mark.parametrize("dac_bits", [0, 8])
def test_tensor_core_design_matches_fft2_oracle(dac_bits):
    a = _rand(14, (2, 512, 512))
    whr, whi = od.dft_matrix_factors(512)
    tr, ti = _tc_stage1(whr, whi, torch.from_numpy(a), dac_bits)
    got = _tc_stage2(tr, ti, whr, whi).numpy()
    for i in range(2):
        want = np.asarray(jref.optical_dft2_intensity_ref(
            jnp.asarray(a[i]), dac_bits=dac_bits))
        _close(got[i], want, 2e-4, 2e-4 * float(want.max()))


@pytest.mark.parametrize("k,n,offset,want", [
    (512, 512, 0, "tensor_core"), (64, 64, 0, "tensor_core"),
    (256, 36, 0, "tensor_core"), (256, 130, 0, "fma"), (6, 64, 0, "fma"),
    (512, 512, 1, "fma"), (512, 512, 4, "tensor_core")])
def test_route_follows_shapes_and_alignment(k, n, offset, want):
    """Alignment is of the data, in elements of 4 bytes from a 64-byte
    aligned buffer: an offset of 1 is 4 bytes, of 4 is 16."""
    buf = torch.zeros(k * n + 16)
    base = (-buf.data_ptr() % 64) // 4
    a = buf[base + offset: base + offset + k * n].view(1, k, n)
    w = torch.zeros(8, k)
    assert od.route(k, n, w, w, a) == want


@pytest.mark.parametrize("dac_bits,want", [
    (0, "tensor_core"), (8, "tensor_core"), (23, "tensor_core"),
    (24, "fma"), (31, "fma")])
def test_route_sends_dacs_past_the_exact_quotient_to_fma(dac_bits, want):
    """The tensor-core route's DAC quotient is exact below 2^23 levels
    (test_dac_quotient_is_the_ieee_quotient); a DAC of 24 bits or more
    takes the FMA route, which divides."""
    a, w = torch.zeros(1, 64, 64), torch.zeros(8, 64)
    assert od.route(64, 64, w, w, a, dac_bits=dac_bits) == want


def test_split_depends_on_shapes_alone():
    # a 512x512 frame is 32 tiles: 2 CTAs share each tile's 16 k steps,
    # so the flush's two frames fill 128 of the card's 132 SMs
    for stage in (1, 2):
        assert od.tc_split(stage, 512, 512, 512) == 2
        assert od.tc_split(stage, 64, 64, 64) == 1       # two k steps
        assert od.tc_split(stage, 2048, 512, 2048) == 1  # 512 tiles
    assert od.tc_split(2, 8, 256, 128) == 4   # 2 tiles, 8 k steps


# --- converter boundary --------------------------------------------------------


@pytest.mark.parametrize("shape", [(8, 128), (64, 256), (256, 512), (16, 384)])
@pytest.mark.parametrize("bits", [(6, 8), (8, 8), (4, 12)])
def test_converter_boundary_matches_reference(shape, bits):
    dac, adc = bits
    x = _rand(6, shape)
    nz = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    (jx, tx), (jn, tn) = _both(x), _both(nz)
    want = jops.converter_boundary(jx, jn, dac_bits=dac, adc_bits=adc,
                                   noise_std=0.02)
    got = tops.converter_boundary(tx, tn, dac_bits=dac, adc_bits=adc,
                                  noise_std=0.02)
    _close(got, want, 1e-6, 1.5 / ((1 << adc) - 1))
    _close(tref.converter_boundary_ref(tx, tn, dac_bits=dac, adc_bits=adc,
                                       noise_std=0.02),
           jref.converter_boundary_ref(jx, jn, dac_bits=dac, adc_bits=adc,
                                       noise_std=0.02),
           1e-6, 1.5 / ((1 << adc) - 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_boundary_dtypes_match_reference(dtype):
    x = _rand(8, (32, 128))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jops.converter_boundary(jx, dac_bits=8, adc_bits=8)
    got = tops.converter_boundary(tx, dac_bits=8, adc_bits=8)
    assert got.dtype == tx.dtype
    _close(got.to(torch.float32), np.asarray(want, np.float32), 1e-2, 1e-2)


def test_converter_boundary_plain_is_the_oracle():
    """The plain version beside the kernel computes the oracle's function,
    noise in float32 or in x's dtype, and rejects what the kernel would."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.random((33, 70), dtype=np.float32) * 1.4 - 0.2)
    nz = torch.from_numpy(rng.standard_normal((33, 70)).astype(np.float32))
    for xt, nt in ((x, nz), (x.bfloat16(), nz), (x.bfloat16(), nz.bfloat16()),
                   (x, None)):
        got = adc_dac.converter_boundary_plain(xt, nt, dac_bits=6,
                                               adc_bits=10, noise_std=0.05)
        want = tref.converter_boundary_ref(xt, nt, dac_bits=6, adc_bits=10,
                                           noise_std=0.05)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        tops.converter_boundary(x[0])                     # not 2-D
    with pytest.raises(ValueError):
        tops.converter_boundary(x, nz[:, :5], noise_std=0.1)
    with pytest.raises(ValueError):
        tops.converter_boundary(x, dac_bits=0)


# --- NaN, infinities and negative inputs against the reference ---------------
#
# jnp.clip and jnp.max keep NaN, and so must the port: its plain versions
# (torch.clamp, torch.amax) and, on the card, its kernels' clips
# (csrc/hopper.cuh: unit_clip) and max.  The plain converter boundary
# computes the oracle's operations in its order, so it is held to
# ``repro.kernels.ref`` bit for bit; the reference's Pallas kernel
# (interpret mode) rounds some steps otherwise, so it is held to the same
# NaN positions and, elsewhere, to the bounds above.

_SPECIALS = ["nan in x", "nan in noise", "+inf in x", "-inf in x",
             "inf in noise", "all negative"]


def _special_inputs(case, shape):
    rng = np.random.default_rng(40)
    x = rng.random(shape, dtype=np.float32) * 1.2 - 0.1
    nz = rng.standard_normal(shape).astype(np.float32)
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
    return x, nz


def _equal_nan(got, want, rtol=0.0, atol=0.0):
    got, want = (torch.as_tensor(np.array(t)) for t in (got, want))
    assert torch.equal(got.isnan(), want.isnan())
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               equal_nan=True)


@pytest.mark.parametrize("case", _SPECIALS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_converter_boundary_keeps_nan_and_inf_as_reference(case, dtype):
    x, nz = _special_inputs(case, (16, 128))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    kw = dict(dac_bits=6, adc_bits=8, noise_std=0.02)
    got = tops.converter_boundary(tx, torch.from_numpy(nz), **kw).float()
    want = jref.converter_boundary_ref(jx, jnp.asarray(nz), **kw)
    _equal_nan(got, want.astype(jnp.float32))
    kern = jops.converter_boundary(jx, jnp.asarray(nz), **kw)
    bound = (1e-6, 1.5 / 255) if dtype == "float32" else (1e-2, 1e-2)
    _equal_nan(got, kern.astype(jnp.float32), *bound)
    # a NaN x or an infinite max (s = inf, 0 * s) makes every element NaN
    nans = {"nan in x": "all", "+inf in x": "all", "nan in noise": "some"}
    assert {"all": bool(got.isnan().all()), "some": bool(got.isnan().any())
            and not bool(got.isnan().all()), None: not bool(
                got.isnan().any())}[nans.get(case)]


@pytest.mark.parametrize("case", ["nan", "+inf", "-inf", "all negative"])
def test_dft_dac_keeps_nan_and_clips_inf_as_reference(case):
    """Through stage 1 with W = I, T is the DAC's output exactly, and a
    column of A with a NaN is NaN (0 * NaN): the oracle gives the same
    bits, the reference's Pallas kernel (whose quotient by the levels is
    off by an ulp in interpret mode) the same NaNs within stage 1's
    bounds.  The whole pipeline: a NaN pixel makes the frame NaN, an
    infinite one is clipped."""
    a = _rand(41, (64, 64)) * 1.2 - 0.1
    if case == "all negative":
        a = -a - 0.2
    else:
        a[::9, 5::11] = {"nan": np.nan, "+inf": np.inf, "-inf": -np.inf}[case]
    eye = np.eye(64, dtype=np.float32)
    ops = tuple(map(jnp.asarray, (eye, np.zeros_like(eye), a)))
    tr, ti = tops.dft_stage1(*(torch.from_numpy(np.array(t)) for t in ops),
                             dac_bits=6)
    for want, bound in ((jref.dft_stage1_ref(*ops, dac_bits=6), (0.0, 0.0)),
                        (jops.dft_stage1(*ops, dac_bits=6), (1e-4, 1e-5))):
        _equal_nan(tr, want[0], *bound)
        _equal_nan(ti, want[1], *bound)
    got = tops.optical_dft2_intensity(torch.from_numpy(a), dac_bits=6)
    want = jref.optical_dft2_intensity_ref(jnp.asarray(a), dac_bits=6)
    assert torch.equal(got.isnan(), torch.from_numpy(np.isnan(want)))
    assert bool(got.isnan().all()) == (case == "nan")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sm_count", [132, 114])
def test_boundary_route_is_resident_up_to_the_cards_shared_memory(dtype,
                                                                   sm_count):
    """One CTA per SM holds ceil(numel / SMs) elements, rounded up to 8,
    in the 227 KB a block may opt in to less the kernel's 1 KB of static
    shared memory and its 16 KB table: up to there the route is
    resident, one element more and it is streamed."""
    smem = 232448                      # an H100's opt-in per block
    per_cta = (smem - 1024 - 16384) // dtype.itemsize // 8 * 8
    most = per_cta * sm_count
    assert adc_dac.route(most, dtype, sm_count, smem) == "resident"
    assert adc_dac.route(most + 1, dtype, sm_count, smem) == "streamed"
    assert adc_dac.route(1, dtype, sm_count, smem) == "resident"
    # chip_smoke.py's cases: 16 MiB of x each
    assert adc_dac.route(2048 * 2048, torch.float32, sm_count,
                         smem) == "resident"
    assert adc_dac.route(4096 * 2048, torch.bfloat16, sm_count,
                         smem) == "resident"
    assert adc_dac.route(8 * most, dtype, sm_count, smem) == "streamed"
