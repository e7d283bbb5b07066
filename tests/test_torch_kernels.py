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
