"""The planner table's twin (``repro_torch.casestudy.planner_table``)
against the reference's ``benchmarks/planner_table.py``, for all ten
architectures (four dense, two recurrent, two MoE, the encoder-decoder
and the vision model).

* Fed the reference's FLOP counts, with the port's host peak set to the
  reference's (197e12, a TPU v5e's bf16 rate), every row is the
  reference's: category shares and speedups to 1e-9 relative (the same
  float arithmetic in the same order), verdict flags equal.
* From its own counts (``flops_by_category`` on ``meta``), matmul, conv
  and fft FLOPs equal the reference's to 1e-9 relative (integer counts
  from shapes by the same rules); 'other' is approximate by design and is
  held within [0.5, 2] of the reference's, as ``test_torch_profiler.py``
  holds it; the verdict flags at the reference's peak are the
  reference's.
* The shape table (``SHAPES``, ``applicable``) equals the reference's.
"""

import dataclasses
import math

import pytest

import benchmarks.planner_table as jplanner
from repro.configs import shapes as jshapes
from repro_torch import configs as tcfgs
from repro_torch.casestudy import planner_table as tplanner

ARCHS = ("seamless-m4t-large-v2", "qwen2-72b", "qwen2.5-32b",
         "stablelm-1.6b", "nemotron-4-340b", "recurrentgemma-9b",
         "llava-next-34b", "qwen2-moe-a2.7b", "deepseek-v3-671b",
         "xlstm-125m")
FLAGS = ("mvm_worthwhile", "mvm_conversion_bound", "fourier_worthwhile")


@pytest.fixture(scope="module")
def reference():
    """arch -> (FLOPs by category, tokens, row) of the reference."""
    out = {}
    for arch in ARCHS:
        cats, tokens = jplanner._arch_profile(arch)
        out[arch] = (cats, tokens)
    saved = jplanner.cfgs.ARCHS
    jplanner.cfgs.ARCHS = {a: saved[a] for a in ARCHS}
    try:
        rows = jplanner.run()
    finally:
        jplanner.cfgs.ARCHS = saved
    return {r["arch"]: out[r["arch"]] + (r,) for r in rows}


def _close(a, b):
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0)


def _assert_same_row(got, want):
    assert got["arch"] == want["arch"]
    assert got["flops_pct"].keys() == want["flops_pct"].keys()
    for k, v in want["flops_pct"].items():
        assert _close(got["flops_pct"][k], v), k
    for k in ("mvm_speedup", "fourier_speedup"):
        assert _close(got[k], want[k]), k
    for k in FLAGS:
        assert got[k] == want[k], k


def test_ported_archs_are_the_four_dense_ones():
    assert set(tcfgs.ARCHS) == set(ARCHS)
    assert tplanner.HOST_PEAK == 989e12


@pytest.mark.parametrize("arch", ARCHS)
def test_rows_equal_reference_on_its_counts(reference, monkeypatch, arch):
    monkeypatch.setattr(tplanner, "HOST_PEAK", jplanner.TPU_PEAK)
    cats, tokens, want = reference[arch]
    _assert_same_row(tplanner.arch_row(arch, cats, tokens), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_own_counts_and_verdicts_match_reference(reference, monkeypatch,
                                                 arch):
    cats, tokens, want = reference[arch]
    got_cats, got_tokens = tplanner._arch_profile(arch)
    assert got_tokens == tokens
    for cat in ("matmul", "conv", "fft"):
        assert _close(got_cats.get(cat, 0.0), cats.get(cat, 0.0)), cat
    assert 0.5 <= got_cats["other"] / cats["other"] <= 2.0
    monkeypatch.setattr(tplanner, "HOST_PEAK", jplanner.TPU_PEAK)
    row = tplanner.arch_row(arch, got_cats, got_tokens)
    for k in FLAGS:
        assert row[k] == want[k], k


def test_run_gives_one_row_per_ported_arch_at_the_h100_peak(reference):
    rows = tplanner.run()
    assert [r["arch"] for r in rows] == list(tcfgs.ARCHS) == list(ARCHS)
    for r in rows:
        assert r["mvm_speedup"] >= 1.0 and r["fourier_speedup"] >= 1.0
        assert not r["mvm_worthwhile"] and not r["fourier_worthwhile"]
        assert _close(sum(r["flops_pct"].values()), 100.0)


def test_shape_table_equals_reference():
    assert tcfgs.SHAPES.keys() == jshapes.SHAPES.keys()
    for name, sh in tcfgs.SHAPES.items():
        assert dataclasses.asdict(sh) == dataclasses.asdict(
            jshapes.SHAPES[name])
    for family in ("dense", "hybrid", "ssm", "moe", "vlm", "audio"):
        assert tcfgs.applicable_shapes(family) == \
            jshapes.applicable_shapes(family)
        for name in tcfgs.SHAPES:
            assert tcfgs.applicable(family, name) == \
                jshapes.applicable(family, name)
