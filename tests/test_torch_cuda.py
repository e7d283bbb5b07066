"""The port's CUDA kernels and its executor on the card.

Every test here needs a CUDA card and skips without one (the decision is
made inside each test, through the ``cuda_device`` fixture).  The file
imports ``torch``, numpy and ``repro_torch`` only, so it runs on a machine
with a card and no JAX:

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_cuda.py

Bounds are the reference's (``tests/test_kernels.py``): stage 1 rtol 1e-4
/ atol 1e-5, stage 2 rtol 1e-4 / atol 1e-4*max, each kernel against its
plain PyTorch version on the same card with TF32 off.  The executor's
``optical-sim`` frames are held to the ``host`` backend within 2e-4*max
plus one 14-bit ADC step of the frame's full scale.
"""

import numpy as np
import pytest
import torch

from repro_torch import runtime as trt
from repro_torch.kernels import optical_dft as od

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
                                         (1, 8, 256, 128), (3, 128, 128, 256)])
def test_kernels_match_plain_versions(cuda_device, batch, m, k, n):
    wr, wi = _rows(k, m, cuda_device)
    a = _rand(20, (batch, k, n), cuda_device)
    od.reset_launches()
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=8)
    pr, pi = od.dft_stage1_batched_plain(wr, wi, a, dac_bits=8)
    assert od.dft_stage1_batched.launches == 1
    torch.testing.assert_close(tr, pr, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ti, pi, rtol=1e-4, atol=1e-5)
    w2r, w2i = _rows(n, n, cuda_device)
    got = od.dft_stage2_batched(tr, ti, w2r, w2i)
    want = od.dft_stage2_batched_plain(tr, ti, w2r, w2i)
    assert od.dft_stage2_batched.launches == 1
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.max()))


@pytest.mark.parametrize("value,bits", [(0.5, 8), (0.4960784316062927, 8),
                                        (0.5, 1)])
def test_dac_rounds_ties_to_even(cuda_device, value, bits):
    wr, wi = od.dft_matrix_factors(64, device=cuda_device)
    a = torch.full((1, 64, 64), value, device=cuda_device)
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=bits)
    pr, pi = od.dft_stage1_batched_plain(wr, wi, a, dac_bits=bits)
    torch.testing.assert_close(tr, pr, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(ti, pi, rtol=1e-4, atol=1e-5)


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
