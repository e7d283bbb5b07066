"""Parity of the port's cost model, planner and tiling with the reference.

These modules are pure Python and numpy in both packages, so the bound is
exact equality: every float of every ``StepCost``, plan, flip fraction and
tile choice must be bit-identical.  The same spec objects cross between
the packages through ``repro_torch.convert.spec_from_fields``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import accelerator as jacc
from repro.core import conversion as jconv
from repro.core import planner as jplan
from repro.runtime import specs as jspecs
from repro.runtime import tiling as jtil
from repro_torch.convert import spec_from_fields, tensor_from_numpy
from repro_torch.core import accelerator as tacc
from repro_torch.core import conversion as tconv
from repro_torch.core import planner as tplan
from repro_torch.runtime import specs as tspecs
from repro_torch.runtime import tiling as ttil

FOURIER = ("PROTOTYPE_4F", "IDEAL_4F")
N = 128 * 128


def _pair(name):
    """The reference's spec and the port's, by name."""
    if name == "BATCHED_4F":
        return jspecs.BATCHED_4F, tspecs.BATCHED_4F
    return getattr(jacc, name), getattr(tacc, name)


def _eq(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# --- specs carried across --------------------------------------------------------


@pytest.mark.parametrize("name", FOURIER + ("ANDERSON_MVM", "BATCHED_4F"))
def test_spec_from_fields_rebuilds_port_spec(name):
    j, t = _pair(name)
    rebuilt = spec_from_fields(dataclasses.asdict(j))
    assert rebuilt == t
    assert type(rebuilt) is type(t)
    assert isinstance(rebuilt.dac, tconv.ConverterSpec)


def test_spec_from_fields_rejects_unknown_fields():
    with pytest.raises(ValueError):
        spec_from_fields({"name": "x", "bits": 8})


def test_tensor_from_numpy_keeps_values():
    a = np.random.default_rng(0).random((3, 4), dtype=np.float32)
    t = tensor_from_numpy(a, device="cpu")
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), a)


# --- StepCost in every mode -----------------------------------------------------

_FOURIER_MODES = [
    dict(batch=1),
    dict(batch=16),
    dict(batch=16, pipeline_depth=2),
    dict(batch=7, pipeline_depth=2, host_s=1e-3),
    dict(batch=16, n_devices=4, pipeline_depth=2),
    dict(batch=16, tile_k=4, pipeline_depth=2),
    dict(batch=9, tile_k=2, pipeline_depth=1),
    dict(batch=16, resident_frames=5, pipeline_depth=2),
    dict(batch=16, resident_frames=16),
    dict(batch=8, delta_fractions=(0.25, 0.5, 0.125), resident_frames=2),
    dict(batch=8, hold_s=2e-3, pipeline_depth=2),
    dict(batch=4, weight_samples=N, resident_weights=N // 2),
]


@pytest.mark.parametrize("name", FOURIER + ("BATCHED_4F",))
@pytest.mark.parametrize("mode", range(len(_FOURIER_MODES)))
def test_batched_step_cost_equal(name, mode):
    j, t = _pair(name)
    kw = _FOURIER_MODES[mode]
    _eq(j.batched_step_cost(N, N, **kw), t.batched_step_cost(N, N, **kw))


@pytest.mark.parametrize("name", FOURIER + ("BATCHED_4F",))
@pytest.mark.parametrize("limit", [1 << 20, 48 << 20, 0])
def test_batched_step_cost_mem_budget_equal(name, limit):
    j, t = _pair(name)
    jb, tb = jtil.MemoryBudget(limit), ttil.MemoryBudget(limit)
    for depth in (1, 2):
        _eq(j.batched_step_cost(512 * 512, batch=16, pipeline_depth=depth,
                                mem_budget=jb),
            t.batched_step_cost(512 * 512, batch=16, pipeline_depth=depth,
                                mem_budget=tb))


@pytest.mark.parametrize("name", FOURIER + ("BATCHED_4F",))
def test_engines_composition_equal(name):
    j, t = _pair(name)
    kw_a = dict(n_in=N, batch=8, pipeline_depth=2)
    kw_b = dict(n_in=N // 4, batch=3, pipeline_depth=2, resident_frames=1)
    _eq(j.batched_step_cost(N, engines={"a": kw_a, "b": kw_b}),
        t.batched_step_cost(N, engines={"a": kw_a, "b": kw_b}))
    pre_j = j.batched_step_cost(N, batch=4)
    pre_t = t.batched_step_cost(N, batch=4)
    _eq(pre_j, pre_t)
    _eq(j.batched_step_cost(N, engines={"a": pre_j, "b": kw_a}),
        t.batched_step_cost(N, engines={"a": pre_t, "b": kw_a}))


@pytest.mark.parametrize("kw", [dict(batch=1), dict(batch=8),
                                dict(batch=8, pipeline_depth=2),
                                dict(batch=8, resident_frames=3,
                                     delta_fractions=(0.5,))])
def test_mvm_costs_equal(kw):
    j, t = jacc.ANDERSON_MVM, tacc.ANDERSON_MVM
    _eq(j.step_cost(4096, 64), t.step_cost(4096, 64))
    _eq(j.batched_step_cost(4096, 64, **kw), t.batched_step_cost(4096, 64, **kw))
    for ww in (False, True):
        _eq(j.matmul_cost(64, 300, 200, weight_write=ww),
            t.matmul_cost(64, 300, 200, weight_write=ww))


@pytest.mark.parametrize("k,tile", [(16, 4), (17, 5), (3, 8), (1, 1)])
def test_tile_sizes_equal(k, tile):
    assert jacc.tile_sizes(k, tile) == tacc.tile_sizes(k, tile)


# --- planner ------------------------------------------------------------------


def _profiles(mod):
    P = mod.CategoryProfile
    return [P("fft", host_s=0.4, calls=64, samples_in=64 * N,
              samples_out=64 * N),
            P("conv", host_s=0.2, calls=32, samples_in=32 * N,
              samples_out=32 * N, host_post_s=0.01, rel_err=0.3),
            P("matmul", host_s=0.05, calls=8, samples_in=8 * 4096,
              samples_out=8 * 64),
            P("other", host_s=0.3)]


@pytest.mark.parametrize("name", FOURIER + ("ANDERSON_MVM", "BATCHED_4F"))
@pytest.mark.parametrize("max_batch", [1, 16, {"fft": 8, "conv": 2}])
def test_plan_offload_equal(name, max_batch):
    j, t = _pair(name)
    pj = jplan.plan_offload(_profiles(jplan), j, max_batch=max_batch)
    pt = tplan.plan_offload(_profiles(tplan), t, max_batch=max_batch)
    assert dataclasses.asdict(pj) == dataclasses.asdict(pt)
    assert pj.summary() == pt.summary()


# --- the LSB-flip / delta model --------------------------------------------------


@pytest.mark.parametrize("bits", [1, 6, 8])
def test_flip_model_equal(bits):
    rng = np.random.default_rng(bits)
    a = rng.random((32, 32)).astype(np.float32)
    b = a.copy()
    b[:4] += 0.01
    for full in (1 << 16, 16):  # exact codes, then the plane estimate
        sj = [jconv.code_signature(x, bits, full_code_max=full) for x in (a, b)]
        st = [tconv.code_signature(tensor_from_numpy(x, "cpu"), bits,
                                   full_code_max=full) for x in (a, b)]
        assert sj[0].plane_counts == st[0].plane_counts
        fj = jconv.expected_flip_fraction(*sj)
        ft = tconv.expected_flip_fraction(*st)
        assert fj == ft
        assert jconv.delta_write_scale(fj, bits) == \
            tconv.delta_write_scale(ft, bits)


@pytest.mark.parametrize("enob", [0.0, 4.0, 12.0])
def test_enob_error_bound_equal(enob):
    assert jconv.enob_error_bound(enob) == tconv.enob_error_bound(enob)


# --- tiling ------------------------------------------------------------------------


@pytest.mark.parametrize("limit", [4 << 20, 50 << 20, 300 << 20, 0])
@pytest.mark.parametrize("n_in,k", [(128 * 128, 16), (512 * 512, 16),
                                    (512 * 512, 6), (64 * 64, 3)])
def test_choose_tile_equal(limit, n_in, k):
    jb, tb = jtil.MemoryBudget(limit), ttil.MemoryBudget(limit)
    for depth in (1, 2):
        pj = jtil.choose_tile(n_in, k, jb, pipeline_depth=depth)
        pt = ttil.choose_tile(n_in, k, tb, pipeline_depth=depth)
        assert (pj.tile_k, pj.k, pj.bytes_per_frame) == \
            (pt.tile_k, pt.k, pt.bytes_per_frame)
        assert jb.tile_for_group(n_in, None, k, pipeline_depth=depth) == \
            tb.tile_for_group(n_in, None, k, pipeline_depth=depth)
    assert jb.minus(1 << 20).bytes_limit == tb.minus(1 << 20).bytes_limit


@pytest.mark.parametrize("shape", [(16, 512, 512), (4, 128, 128),
                                   (5, 64, 64), (1, 8, 128), (3, 128, 256)])
@pytest.mark.parametrize("limit", [1 << 20, 50 << 20, 0])
def test_choose_blocks_equal(shape, limit):
    b, h, w = shape
    jb = jtil.choose_blocks(b, h, w, w, jtil.MemoryBudget(limit))
    tb = ttil.choose_blocks(b, h, w, w, ttil.MemoryBudget(limit))
    assert jb.key == tb.key
    assert jtil.choose_blocks(b, h, w, w, None).key == \
        ttil.choose_blocks(b, h, w, w, None).key


def test_cpu_budget_detection_matches_reference():
    """On the CPU both packages derive the budget from the same LLC."""
    _eq(ttil.MemoryBudget.detect("cpu"), jtil.MemoryBudget.detect("cpu"))


def test_budget_detection_defaults_to_the_card(monkeypatch):
    """``MemoryBudget.detect()`` sizes the CUDA card's budget and raises
    without one, as the executor's default device does; the CPU's LLC
    budget is asked for by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttil.MemoryBudget.detect()
    cpu = ttil.MemoryBudget.detect("cpu")
    assert cpu.source == "llc" and cpu.reserve == 0.5
    assert cpu.bytes_limit == ttil._llc_bytes()
