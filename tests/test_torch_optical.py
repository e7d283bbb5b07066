"""Parity of the port's 4f physics model with the reference's.

Inputs are made once with numpy from a seed and fed to both packages.
Tolerances, and why:

* the DAC is exact: both quantize in float32 with round-half-to-even, so
  the integer codes must be equal, ties included;
* every ADC output may differ by one ADC step of its frame's full scale:
  the intensities it quantizes come from two FFT libraries and differ in
  the last float32 bits, which can move a value across a rounding
  boundary;
* the quantizers' straight-through gradients are equal to float32
  rounding (rtol 1e-6), the gradient ties at the clip boundaries
  included; through the whole pipeline the gradient is evaluated at the
  quantized intensity, whose last bits come from the FFT library, so it
  is held to rtol 1e-3 / atol 1e-4*max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optical as jopt
from repro_torch.core import optical as topt

TIES = np.array([0.5, 0.4960784316062927, 0.0, 1.0, -0.2, 1.3],
                np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("bits", [1, 3, 8, 12])
def test_dac_quantize_codes_equal(bits):
    x = np.concatenate([np.random.default_rng(bits).random(4096,
                                                           dtype=np.float32),
                        TIES])
    levels = (1 << bits) - 1
    cj = np.rint(np.asarray(jopt.dac_quantize(jnp.asarray(x), bits)) * levels)
    ct = np.rint(topt.dac_quantize(_t(x), bits).numpy() * levels)
    np.testing.assert_array_equal(cj, ct)


def test_dac_ties_round_half_to_even():
    # 0.5 * 255 = 127.5 -> 128; 0.49607843 * 255 = 126.5 -> 126 (even),
    # where round-half-away would give 127; 0.5 at 1 bit -> 0
    q8 = topt.dac_quantize(_t(TIES[:2]), 8).numpy() * 255
    np.testing.assert_array_equal(np.rint(q8), [128.0, 126.0])
    assert float(topt.dac_quantize(_t(np.float32([0.5])), 1)) == 0.0


def _step(full_scale, bits):
    return np.asarray(full_scale) / ((1 << bits) - 1)


@pytest.mark.parametrize("bits", [4, 8, 14])
def test_adc_quantize_within_one_step(bits):
    x = np.random.default_rng(10 + bits).random((32, 32)).astype(np.float32)
    x = 7.0 * x ** 3
    got = topt.adc_quantize(_t(x), bits).numpy()
    want = np.asarray(jopt.adc_quantize(jnp.asarray(x), bits))
    np.testing.assert_allclose(got, want, rtol=0, atol=_step(x.max(), bits))


@pytest.mark.parametrize("bits", [6, 14])
def test_adc_quantize_batched_scales_per_frame(bits):
    rng = np.random.default_rng(20 + bits)
    x = rng.random((4, 16, 16)).astype(np.float32)
    x *= np.float32([1.0, 1e-3, 50.0, 0.2])[:, None, None]
    got = topt.adc_quantize_batched(_t(x), bits).numpy()
    want = np.asarray(jopt.adc_quantize_batched(jnp.asarray(x), bits))
    for i in range(4):
        np.testing.assert_allclose(got[i], want[i], rtol=0,
                                   atol=_step(x[i].max(), bits))
        # per-frame == a loop of single-frame calls (batching must not
        # couple one frame's range to another's)
        one = topt.adc_quantize(_t(x[i]), bits).numpy()
        np.testing.assert_array_equal(got[i], one)


def test_ste_gradient_of_quantizers_matches_reference():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.random(256, dtype=np.float32) * 1.4 - 0.2,
                        TIES])
    w = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(v):
        return jnp.sum(jopt.dac_quantize(v, 6) * w) \
            + jnp.sum(jopt.adc_quantize(v + 0.3, 8) * w)

    gj = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = _t(x).clone().requires_grad_(True)
    loss = torch.sum(topt.dac_quantize(xt, 6) * _t(w)) \
        + torch.sum(topt.adc_quantize(xt + 0.3, 8) * _t(w))
    loss.backward()
    np.testing.assert_allclose(xt.grad.numpy(), gj, rtol=1e-6, atol=1e-7)


def test_ste_gradient_through_pipeline_matches_reference():
    a = np.random.default_rng(7).random((16, 16)).astype(np.float32)
    p_j = jopt.OpticalSimParams(dac_bits=6, adc_bits=6)
    p_t = topt.OpticalSimParams(dac_bits=6, adc_bits=6)
    gj = np.asarray(jax.grad(
        lambda v: jnp.sum(jopt.optical_fft2_magnitude(v, p_j) ** 2))(
            jnp.asarray(a)))
    at = _t(a).clone().requires_grad_(True)
    (topt.optical_fft2_magnitude(at, p_t) ** 2).sum().backward()
    gt = at.grad.numpy()
    assert np.isfinite(gt).all() and np.abs(gt).max() > 0.0
    np.testing.assert_allclose(gt, gj, rtol=1e-3,
                               atol=1e-4 * np.abs(gj).max())


@pytest.mark.parametrize("shape", [None, (32, 32)])
def test_fourier_mask_equal(shape):
    k = np.zeros((32, 32) if shape is None else (5, 5), np.float32)
    k[:3, :3] = np.random.default_rng(4).standard_normal((3, 3))
    # the reference's jitted mask cannot pad to a traced ``shape``, so it
    # is given the kernel already padded with numpy
    kp = k if shape is None else np.pad(k, ((0, 27), (0, 27)))
    mj = np.asarray(jopt.fourier_mask_for_kernel(jnp.asarray(kp)))
    mt = topt.fourier_mask_for_kernel(_t(k), shape).numpy()
    assert mt.dtype == np.complex64 and mt.shape == mj.shape
    np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-6 * np.abs(mj).max())


@pytest.mark.parametrize("adc_bits", [8, 12])
def test_optical_conv2d_batched_within_one_adc_step(adc_bits):
    rng = np.random.default_rng(30 + adc_bits)
    vals = rng.random((3, 32, 32)).astype(np.float32)
    k = np.zeros((32, 32), np.float32)
    k[0, 0], k[0, 1], k[2, 3] = 0.6, 0.3, 0.1
    pj = jopt.OpticalSimParams(dac_bits=8, adc_bits=adc_bits)
    pt = topt.OpticalSimParams(dac_bits=8, adc_bits=adc_bits)
    mask_j = jopt.fourier_mask_for_kernel(jnp.asarray(k))
    mask_t = topt.fourier_mask_for_kernel(_t(k))
    want = np.asarray(jopt.optical_conv2d_batched(jnp.asarray(vals), mask_j,
                                                  pj))
    got = topt.optical_conv2d_batched(_t(vals), mask_t, pt).numpy()
    for i in range(3):
        # the four captures of frame i share one full scale: the largest
        # |F * mask + r|^2 over them bounds it
        field = np.fft.fft2(np.rint(vals[i] * 255) / 255, norm="ortho") \
            * np.asarray(mask_j)
        scale = (np.abs(field).max() + 1.0) ** 2
        np.testing.assert_allclose(got[i], want[i], rtol=0,
                                   atol=_step(scale, adc_bits))
        one = topt.optical_conv2d(_t(vals[i]), mask_t, pt).numpy()
        np.testing.assert_allclose(got[i], one, rtol=0, atol=1e-6)


def test_complex_capture_and_magnitude_within_one_adc_step():
    a = np.random.default_rng(8).random((32, 32)).astype(np.float32)
    pj, pt = jopt.IDEAL_SIM, topt.IDEAL_SIM
    mj = np.asarray(jopt.optical_fft2_magnitude(jnp.asarray(a), pj))
    mt = topt.optical_fft2_magnitude(_t(a), pt).numpy()
    step = _step(mj.max() ** 2, pj.adc_bits)
    np.testing.assert_allclose(mt ** 2, mj ** 2, rtol=0, atol=step)
    cj = np.asarray(jopt.optical_fft2_complex(jnp.asarray(a), pj))
    ct = topt.optical_fft2_complex(_t(a), pt).numpy()
    scale = (np.abs(np.fft.fft2(a, norm="ortho")).max() + 1.0) ** 2
    np.testing.assert_allclose(ct, cj, rtol=0, atol=_step(scale, 16))


def test_noise_draws_from_a_generator():
    p = topt.OpticalSimParams(dac_bits=8, adc_bits=8, shot_noise=0.01,
                              read_noise=0.001)
    a = _t(np.random.default_rng(6).random((32, 32)).astype(np.float32))
    m1 = topt.optical_fft2_magnitude(a, p, torch.Generator().manual_seed(1))
    m1b = topt.optical_fft2_magnitude(a, p, torch.Generator().manual_seed(1))
    m2 = topt.optical_fft2_magnitude(a, p, torch.Generator().manual_seed(2))
    torch.testing.assert_close(m1, m1b, rtol=0, atol=0)
    assert not torch.allclose(m1, m2)
    assert float(m1.min()) >= 0.0
