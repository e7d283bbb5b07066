"""The port's shape-only dry run (``repro_torch.launch.dryrun``) against
the reference's ``repro.launch.dryrun``.

* Its tables (``ACCUM``, ``ADAFACTOR_ARCHS``, ``OPT_SETTINGS``) and its
  cells (``all_cells``) are the reference's.
* ``analytic_memory`` is the reference's arithmetic: given the same trees
  and mesh sizes, every term equals the reference's to 1e-9 relative and
  the fit flags are equal, for every (arch, shape, mesh) of
  ``all_cells()``.
* A train cell at a smoke config, counted on ``meta``, has the
  reference's matmul, conv and fft FLOPs (``flops_by_category`` of the
  reference's train step) to 1e-9 relative, and 'other' within [0.5, 2]
  of the reference's, as ``test_torch_planner_table.py`` holds them: a
  dense, a MoE and the encoder-decoder arch.  The xLSTM cell's time
  loops, counted on ``meta`` as step 0 plus one step times the remaining
  trips, give the matmul FLOPs of the loop walked on the CPU exactly.
  (The reference's walk of xlstm-125m's smoke train step counts 1.5 %
  more matmul FLOPs than the port's, 8.65e6 of 5.98e8, 8.39e6 of them the
  sLSTM's four input projections: its scan body takes them step by step
  and its remat'd backward counts them once more; the port takes them
  before the loop.)
* The CLI runs a decode cell and a long-context cell on both production
  meshes (built over torch's fake process group) in a subprocess and
  writes their records, with None under the keys only an XLA compile
  gives.
"""

import json
import math
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro import configs as jcfgs
from repro.configs.shapes import Shape as JShape
from repro.core.profiler import flops_by_category as jflops
from repro.models import LM as JLM
from repro.models import params as jparams
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tcfgs
from repro_torch.core.profiler import counted
from repro_torch.launch import dryrun as tdry
from repro_torch.models import LM
from repro_torch.models.params import init_params, map_tree

_saved = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as jdry  # noqa: E402  (sets XLA_FLAGS)
if _saved is None:        # this process keeps its one device
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _sds(tree):
    return map_tree(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), jnp.dtype(str(t.dtype).replace("torch.", ""))), tree)


def _close(a, b):
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=0.0)


def test_tables_and_cells_equal_reference():
    assert tdry.ACCUM == jdry.ACCUM
    assert tdry.ADAFACTOR_ARCHS == jdry.ADAFACTOR_ARCHS
    assert tdry.OPT_SETTINGS == jdry.OPT_SETTINGS
    assert tdry.all_cells() == jdry.all_cells()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", tdry.all_cells())
def test_analytic_memory_equals_reference(arch, shape_name, mesh):
    dims = MESHES[mesh]
    size = math.prod(dims.values())
    cell = tdry.build_cell(arch, shape_name, tdry.MeshDims(dims, size))
    cfg, sh = tcfgs.get_config(arch), tcfgs.SHAPES[shape_name]
    cache = cell.cache_sds
    if sh.kind == "prefill":
        # the prefill's cache: a decode cache of S + 128 positions, and an
        # encoder-decoder's memory of S / 2 frames
        cache = LM(cfg).init_cache(sh.global_batch, sh.seq_len + 128,
                                   device="meta")
        if cfg.is_encdec:
            cache["enc_out"] = torch.empty(
                (sh.global_batch, sh.seq_len // 2, cfg.d_model),
                dtype=cfg.activation_dtype, device="meta")
    accum = tdry.ACCUM.get(arch, 1)
    got = tdry.analytic_memory(cfg, sh, tdry.MeshDims(dims, size), accum,
                               cell.args[0], cell.opt_sds, cache)
    want = jdry.analytic_memory(
        jcfgs.get_config(arch), jcfgs.SHAPES[shape_name],
        types.SimpleNamespace(shape=dims, size=size), accum,
        _sds(cell.args[0]),
        None if cell.opt_sds is None else _sds(cell.opt_sds),
        None if cache is None else _sds(cache))
    assert set(got) == set(want) | {"fits_h100_80gb"}
    for k, v in want.items():
        if k.startswith("fits"):
            assert got[k] == v, k
        else:
            assert _close(got[k], v), (k, got[k], v)
    assert got["fits_h100_80gb"] == (got["total"] < 80e9)


def _smoke_train_cell(arch):
    return tdry.build_cell(arch, tcfgs.Shape("smoke", 32, 8, "train"),
                           tdry.MeshDims({"data": 1, "model": 1}, 1),
                           cfg=tcfgs.get_smoke_config(arch))


def _train_args(cell):
    return (cell.fn,) + tuple(cell.args)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen2-moe-a2.7b",
                                  "seamless-m4t-large-v2"])
def test_smoke_train_cell_flops_equal_reference(arch):
    """The train cell's step at the smoke config, batch 8 x 32 tokens,
    with the cell's optimizer and accumulation."""
    accum = tdry.ACCUM.get(arch, 1)
    got = counted(*_train_args(_smoke_train_cell(arch)))[0]

    jcfg = jcfgs.get_smoke_config(arch)
    opt = (jadafactor(1e-4) if arch in jdry.ADAFACTOR_ARCHS
           else jadamw(1e-4))
    p_sds = jparams.param_shape_structs(jcfg)
    want = jflops(jmake_train_step(JLM(jcfg), opt, accum_steps=accum),
                  p_sds, jax.eval_shape(opt.init, p_sds),
                  jcfgs.input_specs(jcfg, JShape("smoke", 32, 8, "train")),
                  jax.ShapeDtypeStruct((), jnp.int32))
    for cat in ("matmul", "conv", "fft"):
        assert _close(got.get(cat, 0.0), want.get(cat, 0.0)), cat
    assert 0.5 <= got["other"] / want["other"] <= 2.0


def test_xlstm_time_loops_count_as_walked():
    """xlstm-125m's train cell at the smoke config: on ``meta`` its time
    loops run step 0 and one step for the other 31; on the CPU they are
    walked, 32 steps.  The matmul FLOPs are equal."""
    cell = _smoke_train_cell("xlstm-125m")
    meta = counted(*_train_args(cell))[0]
    params = init_params(tcfgs.get_smoke_config("xlstm-125m"),
                         device="cpu")
    state = map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                     cell.args[1])
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in cell.args[2].items()}
    walked = counted(cell.fn, params, state, batch, 0)[0]
    assert meta["matmul"] == walked["matmul"] > 0
    assert 0.5 <= meta["other"] / walked["other"] <= 2.0


_NULL = ("flops", "bytes_accessed", "bytes_accessed_corrected",
         "collective_bytes", "collective_bytes_total",
         "collective_bytes_corrected", "temp_bytes_per_device",
         "peak_bytes_per_device", "scan_correction", "lower_s",
         "compile_s")


def test_cli_runs_decode_and_long_cells_on_both_meshes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    t0 = time.time()
    cells = [("stablelm-1.6b", "decode_32k"), ("xlstm-125m", "long_500k")]
    # at the lowest CPU priority: the machine's other test workers first
    procs = [subprocess.Popen(
        ["nice", "-n", "19", sys.executable, "-m",
         "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--mesh", "both", "--outdir", str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for arch, shape in cells]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [o[-3000:]
                                                     for o in outs]
    assert time.time() - t0 < 120
    for arch, shape in cells:
        recs = {m: json.loads((tmp_path / f"{arch}__{shape}__{m}.json")
                              .read_text()) for m in ("single", "multi")}
        for mesh, rec in recs.items():
            assert rec["source"] == "meta"
            assert rec["devices"] == (256 if mesh == "single" else 512)
            for k in _NULL:
                assert rec[k] is None, k
            assert rec["jaxpr_flops_global"] > 0
            assert rec["jaxpr_traffic_bytes_global"] > 0
            assert rec["argument_bytes_per_device"] > 0
            mem = rec["analytic_memory_per_device"]
            assert mem["fits_16gb"] and mem["fits_h100_80gb"]
        # the counts are global: the same on both meshes
        assert recs["single"]["jaxpr_flops_by_category"] == \
            recs["multi"]["jaxpr_flops_by_category"]
        assert recs["multi"]["argument_bytes_per_device"] <= \
            recs["single"]["argument_bytes_per_device"]
