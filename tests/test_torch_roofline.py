"""The port's roofline (``repro_torch.casestudy.roofline``) against the
reference's ``benchmarks/roofline.py``.

* Given the same records, ``roofline_row`` and ``run`` equal the
  reference's key for key (1e-12 relative) once the twin is given the
  reference's constants: records of every shape of ``SHAPES`` on both
  meshes, with and without the batch, sequence and kind the port's
  dry run states, a MoE's active parameters below its total.
* The default constants are an H100 SXM's data-sheet figures, and the
  planner table prices at the same peak.
* A record outside ``SHAPES`` takes its token count from itself.
"""

import json
import math

import numpy as np
import pytest

from benchmarks import roofline as jroof
from repro_torch.casestudy import planner_table as tplanner
from repro_torch.casestudy import roofline as troof
from repro_torch.configs import SHAPES

REF = troof.Constants(jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.LINK_BW)


def _records(with_shape_keys: bool) -> list[dict]:
    rng = np.random.default_rng(3)
    out = []
    for arch, active in (("qwen2-72b", 1.0), ("qwen2-moe-a2.7b", 0.2)):
        for name, sh in SHAPES.items():
            for mesh, devices in (("single", 256), ("multi", 512)):
                total = float(rng.uniform(1e9, 1e11))
                rec = {
                    "cell": f"{arch}__{name}__{mesh}", "arch": arch,
                    "shape": name, "mesh": mesh, "devices": devices,
                    "flops": float(rng.uniform(1e12, 1e15)),
                    "jaxpr_flops_global": float(rng.uniform(1e15, 1e18)),
                    "bytes_accessed": float(rng.uniform(1e10, 1e13)),
                    "bytes_accessed_corrected": float(rng.uniform(1e10,
                                                                  1e13)),
                    "collective_bytes_total": float(rng.uniform(1e8, 1e12)),
                    "collective_bytes_corrected": float(rng.uniform(1e8,
                                                                    1e12)),
                    "params_total": total, "params_active": active * total,
                }
                if with_shape_keys:
                    rec.update(kind=sh.kind, global_batch=sh.global_batch,
                               seq_len=sh.seq_len)
                out.append(rec)
    return out


def _same(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, float):
            assert math.isclose(got[k], w, rel_tol=1e-12, abs_tol=0.0), k
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("with_shape_keys", [False, True])
def test_roofline_row_equals_reference_at_its_constants(with_shape_keys):
    for rec in _records(with_shape_keys):
        _same(troof.roofline_row(rec, REF), jroof.roofline_row(rec))


def test_run_equals_reference_at_its_constants(tmp_path):
    for rec in _records(True):
        (tmp_path / f"{rec['cell']}.json").write_text(json.dumps(rec))
    got, want = troof.run(str(tmp_path), REF), jroof.run(str(tmp_path))
    assert len(got) == len(want) == len(SHAPES) * 4
    for g, w in zip(got, want):
        _same(g, w)
    assert troof.table(got).splitlines()[1:] == \
        jroof.table(want).splitlines()[1:]


def test_h100_constants_are_the_data_sheets():
    assert troof.PEAK_FLOPS == 989e12          # dense bf16, SXM
    assert troof.HBM_BW == 3.35e12             # HBM3
    assert troof.LINK_BW == 50e9               # NDR InfiniBand, 400 Gb/s
    assert troof.NVLINK_BW == 450e9            # NVLink 4, one direction
    assert troof.H100 == troof.Constants(989e12, 3.35e12, 50e9)
    assert tplanner.HOST_PEAK == troof.PEAK_FLOPS
    rec = _records(True)[0]
    row = troof.roofline_row(rec)
    assert row["compute_s"] == rec["jaxpr_flops_global"] / (256 * 989e12)
    assert row["memory_s"] == rec["bytes_accessed_corrected"] / 3.35e12
    assert row["collective_s"] == rec["collective_bytes_corrected"] / 50e9


@pytest.mark.parametrize("kind,tokens,mult", [("train", 4 * 1024, 6.0),
                                              ("prefill", 4 * 1024, 2.0),
                                              ("decode", 4, 2.0)])
def test_a_record_outside_shapes_takes_its_tokens_from_itself(kind, tokens,
                                                              mult):
    rec = dict(_records(False)[0], shape="phase_step", kind=kind,
               global_batch=4, seq_len=1024, devices=1,
               cell="stablelm-1.6b__phase_step__card")
    assert "phase_step" not in SHAPES
    assert troof.tokens(rec) == tokens
    row = troof.roofline_row(rec)
    assert row["model_flops"] == mult * rec["params_active"] * tokens
    assert row["step_lower_bound_s"] == max(
        row["compute_s"], row["memory_s"], row["collective_s"])


def test_a_port_record_bounds_memory_by_the_bytes_it_must_move():
    """A record of the port's dry run states ``bytes_min``: the memory
    term is that over the HBM rate, and the eager traffic's time stands
    apart as ``traffic_s``, outside the bound."""
    rec = dict(_records(True)[0], bytes_min=2.5e9,
               bytes_accessed_corrected=9e12, jaxpr_flops_global=1e12,
               collective_bytes_corrected=1e6)
    row = troof.roofline_row(rec)
    assert row["memory_s"] == 2.5e9 / 3.35e12
    assert row["traffic_s"] == 9e12 / 3.35e12
    assert row["dominant"] == "memory"
    assert row["step_lower_bound_s"] == max(
        row["compute_s"], row["memory_s"], row["collective_s"])
    assert row["step_lower_bound_s"] < row["traffic_s"]
    assert "traffic_s" not in troof.roofline_row(_records(True)[0])
