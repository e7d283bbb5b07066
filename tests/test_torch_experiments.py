"""The port's EXPERIMENTS.md writer (``repro_torch.casestudy.experiments``)
against the reference's ``experiments/gen_experiments.py``.

* ``main`` writes every section from fixture dry-run records (baseline
  and ``--opt``) and an ``amdahl.json``, with Figure 8 on the CPU; a
  missing record directory or ``amdahl.json`` fails it (exit 1).
* Where a table's columns are the reference's, its rows are the
  reference's on the same records: Amdahl's whole rows; the roofline's
  rows once the twin is given the reference's constants; the dry
  run's cell, devices, FLOPs a device, collective bytes and analytic
  GiB; the hillclimb cells' three roofline terms, baseline and opt.
* A port record's roofline row takes its memory term from the bytes
  the step must move and shows its eager traffic apart; the dry run's
  table says how a 2x16x16 record was counted.
* ``spearman`` equals the reference's.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from benchmarks import roofline as jroof
from repro_torch.casestudy import experiments as texp
from repro_torch.casestudy import roofline as troof

ROOT = os.path.join(os.path.dirname(__file__), "..")
REF = troof.Constants(jroof.PEAK_FLOPS, jroof.HBM_BW, jroof.LINK_BW)
SECTIONS = ("## Dry run", "## Roofline", "## Baseline against `--opt`",
            "## Amdahl", "## Planner", "## Fig. 8", "## Fig. 2", "## Fig. 3")


def _reference():
    spec = importlib.util.spec_from_file_location(
        "gen_experiments", os.path.join(ROOT, "experiments",
                                        "gen_experiments.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _records(seed: int) -> list[dict]:
    """Records carrying both packages' keys: a few cells on both meshes,
    the three hillclimb cells among them."""
    rng = np.random.default_rng(seed)
    out = []
    for arch, shape in (("qwen2-72b", "train_4k"),
                        ("deepseek-v3-671b", "train_4k"),
                        ("nemotron-4-340b", "train_4k"),
                        ("stablelm-1.6b", "decode_32k"),
                        ("xlstm-125m", "long_500k")):
        for mesh, devices in (("single", 256), ("multi", 512)):
            total = float(rng.uniform(1e9, 1e11))
            gb = float(rng.uniform(1e9, 1e11))
            coll = {"all-gather": float(rng.uniform(1e8, 1e11)),
                    "all-reduce": float(rng.uniform(1e8, 1e11))}
            ba = float(rng.uniform(1e10, 1e13))
            out.append({
                "cell": f"{arch}__{shape}__{mesh}", "arch": arch,
                "shape": shape, "mesh": mesh, "devices": devices,
                "flops": float(rng.uniform(1e12, 1e15)),
                "jaxpr_flops_global": float(rng.uniform(1e15, 1e18)),
                "bytes_accessed": ba, "bytes_accessed_corrected": ba,
                "collective_bytes": coll,
                "collective_bytes_total": sum(coll.values()),
                "collective_bytes_corrected": sum(coll.values()),
                "peak_bytes_per_device": int(rng.uniform(1e9, 1e11)),
                "analytic_memory_per_device": {
                    "total": gb, "fits_16gb": gb < 16 * 2 ** 30,
                    "fits_h100_80gb": gb < 80e9},
                "params_total": total, "params_active": total,
            })
    return out


def _write(d, cells):
    os.makedirs(d, exist_ok=True)
    for c in cells:
        with open(os.path.join(d, c["cell"] + ".json"), "w") as f:
            json.dump(c, f)


def _amdahl() -> list[dict]:
    rng = np.random.default_rng(5)
    return [{"name": f"bench_{i}", "fraction": float(rng.uniform(0, 1)),
             "speedup": float(rng.uniform(1, 50)),
             "paper_frac": float(rng.uniform(0, 100)),
             "paper_speedup": float(rng.uniform(1, 50))} for i in range(27)]


def _rows(text: str) -> list[list[str]]:
    """The data rows of a section's table, as cells."""
    return [[c.strip() for c in ln.strip("|").split("|")]
            for ln in text.splitlines()
            if ln.startswith("| ") and not ln.startswith("| cell |")
            and not ln.startswith("| app |") and not ln.startswith(
                "| variant |")]


@pytest.fixture(scope="module")
def ref():
    return _reference()


def test_main_writes_every_section(tmp_path):
    base, opt = tmp_path / "dryrun", tmp_path / "dryrun_opt"
    _write(base, _records(0))
    _write(opt, _records(1))
    (tmp_path / "amdahl.json").write_text(json.dumps(_amdahl()))
    out = tmp_path / "EXPERIMENTS.md"
    args = ["--device", "cpu", "--dryrun", str(base), "--dryrun-opt",
            str(opt), "--amdahl", str(tmp_path / "amdahl.json"),
            "--out", str(out)]
    assert texp.main(args) == 0
    doc = out.read_text()
    pos = [doc.index(s) for s in SECTIONS]
    assert pos == sorted(pos)
    for cell in texp.HILLCLIMB_CELLS:
        assert doc.count(f"| {cell} |") >= 3     # dry run, opt x2
    # nothing is filled in for what is missing
    (tmp_path / "amdahl.json").unlink()
    assert texp.main(args) == 1
    assert texp.main(args[:3] + [str(tmp_path / "nowhere")] + args[4:]) == 1


def test_amdahl_rows_equal_reference(ref, tmp_path, monkeypatch):
    rows = _amdahl()
    (tmp_path / "amdahl.json").write_text(json.dumps(rows))
    monkeypatch.setattr(ref, "ROOT", str(tmp_path))
    want, got = ref.amdahl_section(), texp.amdahl_section(rows)
    assert _rows(got) == _rows(want) and len(_rows(got)) == 27


def test_roofline_rows_equal_reference_at_its_constants(ref):
    cells = _records(0)
    got = _rows(texp.roofline_section(cells, REF))
    assert [r[:7] for r in got] == _rows(ref.roofline_section(cells))
    assert len(got) == 5
    # the reference's records state no bytes_min: no eager traffic column
    assert [r[7] for r in got] == ["-"] * 5


def test_port_records_show_bound_traffic_and_how_counted():
    """A port record's memory term is its must-move bytes, its eager
    traffic stands apart, and a 2x16x16 record says it was a pod's slice
    with its microbatches counted / configured.  The capped count (8 of
    16) is synthetic, a case of the renderer: no real record is capped
    any more, every one counts all its microbatches."""
    cells = [dict(c, bytes_min=c["bytes_accessed"] / 7,
                  partition=("mesh" if c["mesh"] == "single"
                             else "pod_slice+cross_pod_reduce"),
                  accum_steps=16, accum_counted=(
                      16 if c["mesh"] == "single" else 8))
             for c in _records(0)]
    rows = _rows(texp.roofline_section(cells, troof.H100))
    by_cell = {c["cell"]: c for c in cells}
    for r in rows:
        c = by_cell[r[0]]
        assert r[2] == f"{c['bytes_min'] / troof.HBM_BW:.2e}"
        assert r[7] == f"{c['bytes_accessed'] / troof.HBM_BW:.2e}"
    how = {r[0]: r[7] for r in _rows(texp.dryrun_section(cells))}
    for cell, c in by_cell.items():
        assert how[cell] == ("mesh" if c["mesh"] == "single" else
                             "pod slice + cross-pod reduce, accum 8 / 16")


def test_dryrun_rows_equal_reference_in_shared_columns(ref):
    cells = _records(0)
    want = [[r[i] for i in (0, 1, 2, 3, 5)]
            for r in _rows(ref.dryrun_section(cells))]
    got = _rows(texp.dryrun_section(cells))
    assert [r[:5] for r in got] == want and len(got) == 10


def test_hillclimb_terms_equal_reference(ref):
    base, opt = _records(0), _records(1)
    want = [r[1:4] for r in _rows(ref.perf_section(base, opt))
            if r[0] in ("baseline", "optimized (sp)", "optimized (EP+cf1.0)",
                        "optimized (2-level remat + accum16)")]
    got = [r[2:5] for r in _rows(texp.perf_section(base, opt, REF))]
    assert got == want and len(got) == 6


def test_spearman_equals_reference(ref):
    rng = np.random.default_rng(11)
    for n in (2, 5, 27):
        a, b = list(rng.random(n)), list(rng.random(n))
        assert texp.spearman(a, b) == ref.spearman(a, b)
