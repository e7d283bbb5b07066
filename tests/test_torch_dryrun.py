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
  writes their records: every key of the reference's record, the
  per-device FLOPs, bytes and collective bytes of the partitioned pass,
  ``scan_correction`` 1.0 with the corrected keys equal to the raw ones,
  and None under the keys only an XLA compile gives.
* The partitioned pass (``device_counts``) runs each family's smoke
  config (train, prefill and decode) on a fake ``(data, model)`` (2, 4)
  mesh and a fake ``(pod, data, model)`` (2, 2, 2) mesh, the production
  meshes' names, in a subprocess over a fake group of 8 ranks (no
  process group is made in the pytest process), every configured
  microbatch counted (one a device's row that ``data`` does not divide
  runs padded); ``repeated`` multiplies the collectives it counts; a
  Shard-to-Shard redistribute counts as one all-to-all; on plain tensors
  the count has no collectives and its FLOPs and bytes are
  ``counted``'s.
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
from repro_torch.core.profiler import (COLLECTIVE_KINDS, count_step,
                                      flops_by_category, traffic_bytes)
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


@pytest.mark.parametrize("act", ["baseline", "sp"])
def test_step_bytes_min_counts_what_a_step_must_move(act, monkeypatch):
    """Arguments read once and outputs written once; a decode step's
    aliased cache not written again; a train step's gradients and its
    block-boundary carries written and read back once, the carries a
    device's rows of the residual stream (and its model share under
    'sp')."""
    monkeypatch.setenv("REPRO_ACT_SHARDING", act)
    assert tdry.step_bytes_min("prefill", 10.0, 3.0, 0.0) == 13.0
    assert tdry.step_bytes_min("decode", 10.0, 7.0, 6.0) == 11.0
    assert tdry.step_bytes_min("train", 10.0, 8.0, 8.0, 2.0, 5.0) == 32.0
    cfg = tcfgs.get_config("qwen2-72b")
    sh = tcfgs.SHAPES["train_4k"]
    dims = tdry.MeshDims({"data": 16, "model": 16}, 256)
    want = (cfg.n_layers * sh.global_batch * sh.seq_len * cfg.d_model * 2
            / (16 * (16 if act == "sp" else 1)))
    assert tdry.carry_bytes(cfg, sh, dims) == want


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
    got = count_step(*_train_args(_smoke_train_cell(arch))).flops

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
    meta = count_step(*_train_args(cell)).flops
    params = init_params(tcfgs.get_smoke_config("xlstm-125m"),
                         device="cpu")
    state = map_tree(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                     cell.args[1])
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in cell.args[2].items()}
    walked = count_step(cell.fn, params, state, batch, 0).flops
    assert meta["matmul"] == walked["matmul"] > 0
    assert 0.5 <= meta["other"] / walked["other"] <= 2.0


_NULL = ("temp_bytes_per_device", "peak_bytes_per_device", "lower_s",
         "compile_s")
# the keys of the reference's record (``repro.launch.dryrun.run_cell``)
REF_KEYS = ("cell", "arch", "shape", "mesh", "devices", "flops",
            "jaxpr_flops_global", "jaxpr_flops_by_category",
            "scan_correction", "bytes_accessed", "bytes_accessed_corrected",
            "jaxpr_traffic_bytes_global", "collective_bytes",
            "collective_bytes_total", "collective_bytes_corrected",
            "argument_bytes_per_device", "output_bytes_per_device",
            "temp_bytes_per_device", "alias_bytes_per_device",
            "peak_bytes_per_device", "analytic_memory_per_device",
            "params_total", "params_active", "accum_steps", "lower_s",
            "compile_s")


def test_cli_runs_decode_and_long_cells_on_both_meshes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    t0 = time.time()
    cells = [("stablelm-1.6b", "decode_32k"), ("xlstm-125m", "long_500k")]
    # at the default CPU priority: at the lowest one, beside the whole
    # suite's workers and the mesh file's 9 children, they got only idle
    # CPU and ran past the limit
    procs = [subprocess.Popen(
        [sys.executable, "-m",
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
            assert set(REF_KEYS) <= set(rec), set(REF_KEYS) - set(rec)
            assert rec["source"] == "meta"
            assert rec["devices"] == (256 if mesh == "single" else 512)
            for k in _NULL:
                assert rec[k] is None, k
            assert rec["jaxpr_flops_global"] > 0
            assert rec["jaxpr_traffic_bytes_global"] > 0
            assert rec["argument_bytes_per_device"] > 0
            # the partitioned pass: one device's share, every trip counted
            assert 0 < rec["flops"] < rec["jaxpr_flops_global"]
            assert rec["flops"] == sum(
                v for k, v in rec["flops_by_category_per_device"].items()
                if not k.startswith("__"))
            assert 0 < rec["bytes_accessed"] < \
                rec["jaxpr_traffic_bytes_global"]
            assert rec["scan_correction"] == 1.0
            assert rec["bytes_accessed_corrected"] == rec["bytes_accessed"]
            assert set(rec["collective_bytes"]) <= set(COLLECTIVE_KINDS)
            assert rec["collective_bytes_total"] == sum(
                rec["collective_bytes"].values()) > 0
            assert rec["collective_bytes_corrected"] == \
                rec["collective_bytes_total"]
            assert rec["ce_chunk_collective_bytes"] is None   # not train
            # a decode step must read its arguments and write its logits;
            # its eager traffic is more
            assert rec["bytes_min"] == (rec["argument_bytes_per_device"]
                                        + rec["output_bytes_per_device"]
                                        - rec["alias_bytes_per_device"])
            assert 0 < rec["bytes_min"] < rec["bytes_accessed"]
            assert rec["partition"] == ("mesh" if mesh == "single" else
                                        "pod_slice+cross_pod_reduce")
            assert rec["accum_counted"] == rec["accum_steps"] == 1
            assert (rec["kind"], rec["global_batch"], rec["seq_len"]) == (
                "decode", tcfgs.SHAPES[shape].global_batch,
                tcfgs.SHAPES[shape].seq_len)
            mem = rec["analytic_memory_per_device"]
            assert mem["fits_16gb"] and mem["fits_h100_80gb"]
        # the counts are global: the same on both meshes
        assert recs["single"]["jaxpr_flops_by_category"] == \
            recs["multi"]["jaxpr_flops_by_category"]
        assert recs["multi"]["argument_bytes_per_device"] <= \
            recs["single"]["argument_bytes_per_device"]


# --- the partitioned pass on fake meshes, in subprocesses ---------------------

_PARTITIONED = r'''
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch import configs as cfgs
from repro_torch.core.profiler import count_step, repeated
from repro_torch.distributed.compat import make_auto_mesh
from repro_torch.launch import dryrun

torch.set_num_threads(1)
shape, names, archs, out = json.loads(sys.argv[1])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_auto_mesh(tuple(shape), tuple(names))
res = {}
for arch in archs:
    cfg = cfgs.get_smoke_config(arch)
    for kind in ("train", "prefill", "decode"):
        c, ce, accum = dryrun.device_counts(
            arch, cfgs.Shape("smoke", 16, 32, kind), mesh, cfg=cfg)
        res[f"{arch}/{kind}"] = {"flops": c.flops, "bytes": c.bytes,
                                 "collectives": c.collectives, "ce": ce,
                                 "accum": accum}
# the padded head split: each local launch of kernel 6 in the train
# steps of the smoke configs whose heads ``model`` does not divide
from repro_torch.kernels import ops
plain = ops.gqa_flash_attention
for arch in ("qwen2.5-32b", "nemotron-4-340b"):
    calls = []

    def spy(q, k, v, **kw):
        if not isinstance(q, DTensor):
            calls.append([list(q.shape), list(k.shape), list(v.shape)])
        return plain(q, k, v, **kw)

    ops.gqa_flash_attention = spy
    c, ce, accum = dryrun.device_counts(
        arch, cfgs.Shape("smoke", 16, 32, "train"), mesh,
        cfg=cfgs.get_smoke_config(arch))
    ops.gqa_flash_attention = plain
    res[f"{arch}/padded"] = {"calls": calls, "ce": ce, "accum": accum,
                             "flops": c.flops}
# nemotron-4-340b's smoke train step at its ``--opt`` 16 microbatches
# (at its 8 above): on a pod's slice of (2, 2, 2) the pod's 16 rows in 16
# microbatches of 1 row each, which ``data`` 2 does not divide
dryrun.ACCUM["nemotron-4-340b"] = 16
c, ce, accum = dryrun.device_counts(
    "nemotron-4-340b", cfgs.Shape("smoke", 16, 32, "train"), mesh,
    cfg=cfgs.get_smoke_config("nemotron-4-340b"))
dryrun.ACCUM["nemotron-4-340b"] = 8
res["uneven"] = {"accum": accum, "flops": c.flops,
                 "collectives": c.collectives}
if "pod" not in names:
    # the Adafactor update of qwen2.5-32b's stacked FFN weight (its 64
    # layers; 512 x 2048 for 5120 x 27648) laid out as its dry-run cell
    # lays it (layers, FSDP over data, columns over model), where
    # DTensor re-shards the FSDP split onto the layer dim and back:
    # counted with DTensor's Shard-to-Shard all-to-all as the card sends
    # it, and with the count of its CPU route (an all-gather and a
    # chunk), the bytes of each call beside
    import torch.distributed.tensor.placement_types as pt
    from repro_torch.core import profiler
    from repro_torch.distributed.compat import enter_mesh
    from repro_torch.distributed.sharding import meta_tree, mesh_ops
    from repro_torch.optim import adafactor
    from repro_torch.optim.base import apply_updates
    full = (64, 512, 2048)
    opt = adafactor(1e-4)
    spec = {"w": (None, "data", "model")}
    p = meta_tree({"w": torch.empty(full, dtype=torch.bfloat16,
                                    device="meta")}, spec, mesh)
    g = meta_tree({"w": torch.empty(full, device="meta")}, spec, mesh)
    st = meta_tree(opt.init({"w": torch.empty(full, device="meta")}),
                   {"v": {"w": {"vr": (None, "data"),
                                "vc": (None, "model")}}}, mesh)
    calls = []
    plain = pt.shard_dim_alltoall

    def spy(x, gather_dim, shard_dim, m, mesh_dim):
        out = plain(x, gather_dim, shard_dim, m, mesh_dim)
        calls.append([x.numel() * x.element_size(),
                      out.numel() * out.element_size(), m.size(mesh_dim)])
        return out

    def update():
        with mesh_ops():
            u, _, _ = opt.update(g, st, p, 0)
            return apply_updates(p, u)

    pt.shard_dim_alltoall = spy
    enter_mesh(mesh)
    counted = count_step(update)
    callers, profiler._ALLTOALL_CALLERS = profiler._ALLTOALL_CALLERS, ()
    counted_calls, calls = calls, []
    fallback = count_step(update)
    profiler._ALLTOALL_CALLERS = callers
    enter_mesh(None)
    pt.shard_dim_alltoall = plain
    res["s2s"] = {"calls": counted_calls, "counted": counted.collectives,
                  "fallback": fallback.collectives, "fallback_calls": calls,
                  "tally": [counted.shard_to_shard, fallback.shard_to_shard]}
x = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh,
                       [Shard(0)] + [Replicate()] * (mesh.ndim - 1),
                       run_check=False)
whole = [Replicate()] * mesh.ndim
once = count_step(lambda: x.redistribute(mesh, whole)).collectives


def thrice():
    with repeated(3):
        x.redistribute(mesh, whole)


res["repeated"] = [once, count_step(thrice).collectives]
dist.destroy_process_group()
with open(out, "w") as f:
    json.dump(res, f)
'''

MESHES_SMALL = {"data_model": ((2, 4), ("data", "model")),
                "pod_data_model": ((2, 2, 2), ("pod", "data", "model"))}


def _family_archs() -> list[str]:
    """One arch of each family, and deepseek-v3-671b (MLA) beside the
    first MoE."""
    seen = {}
    for arch in tcfgs.ARCHS:
        seen.setdefault(tcfgs.get_config(arch).family, arch)
    return sorted(set(seen.values()) | {"deepseek-v3-671b"})


@pytest.fixture(scope="module")
def partitioned(tmp_path_factory):
    d = tmp_path_factory.mktemp("partitioned")
    script = d / "partitioned.py"
    script.write_text(_PARTITIONED)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        ["nice", "-n", "19", sys.executable, str(script), json.dumps(
            [list(shape), list(names), _family_archs(),
             str(d / f"{name}.json")])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (shape, names) in MESHES_SMALL.items()}
    try:
        outs = {n: p.communicate(timeout=900)[0] for n, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs.values()), {
        n: o[-3000:] for n, o in outs.items()}
    return {n: json.loads((d / f"{n}.json").read_text())
            for n in MESHES_SMALL}


@pytest.mark.parametrize("mesh", list(MESHES_SMALL))
def test_partitioned_pass_runs_every_family(partitioned, mesh):
    res = partitioned[mesh]
    archs = _family_archs()
    assert len(archs) >= 6
    for arch in archs:
        for kind in ("train", "prefill", "decode"):
            r = res[f"{arch}/{kind}"]
            assert r["flops"]["matmul"] > 0 and r["bytes"] > 0, (arch, kind)
            assert set(r["collectives"]) <= set(COLLECTIVE_KINDS)
            assert sum(r["collectives"].values()) > 0, (arch, kind)
            assert (r["ce"] is None) == (kind != "train")
            assert r["accum"] == (tdry.ACCUM.get(arch, 1)
                                  if kind == "train" else 1)
        # the gradients' reduction across the pods
        if mesh == "pod_data_model":
            assert res[f"{arch}/train"]["collectives"]["all-reduce"] > 0


@pytest.mark.parametrize("mesh", list(MESHES_SMALL))
def test_repeated_multiplies_collectives(partitioned, mesh):
    once, thrice = partitioned[mesh]["repeated"]
    assert once == {"all-gather": 8 * 8 * 4.0}      # max(result, operand)
    assert thrice == {k: 3 * v for k, v in once.items()}


@pytest.mark.parametrize("mesh", list(MESHES_SMALL))
def test_partitioned_pass_pads_uneven_head_splits(partitioned, mesh):
    """qwen2.5-32b's smoke train cell (5 query heads, 1 KV head) and
    nemotron-4-340b's (6 heads, 2 KV heads) on the fake meshes: where
    ``model`` does not divide the heads, each device launches kernel 6
    on its padded heads (``sharding.head_pad``: 5 -> 8 and 6 -> 8 over
    ``model`` 4, 5 -> 6 over 2), not on every head, and on its rows of
    the microbatch.  On (2, 4) the forward work charged a device is
    the padding arithmetic: layers x microbatches x 2 (forward and
    recompute) x 2 x rows x heads x L^2 x (D + Dv), 2/5 and 2/6 of the
    whole-head count."""
    from repro_torch.distributed.sharding import head_pad
    from repro_torch.kernels.local_attention import _attention_work
    shape, names = MESHES_SMALL[mesh]
    m = shape[names.index("model")]
    data = math.prod(shape) // m
    for arch in ("qwen2.5-32b", "nemotron-4-340b"):
        cfg = tcfgs.get_smoke_config(arch)
        r = partitioned[mesh][f"{arch}/padded"]
        h, hk = cfg.n_heads, cfg.n_kv_heads
        hl = len(head_pad(h, hk, m)) // m if h % m else h // m
        assert r["calls"], arch
        for q, k, v in r["calls"]:
            assert q[1] == hl, (arch, mesh, q)
        if mesh != "data_model":
            continue
        rows = 32 // r["accum"] // data
        assert all(q[0] == rows for q, _, _ in r["calls"])
        got = sum(_attention_work(*(torch.empty(t, device="meta")
                                    for t in call))["matmul"]
                  for call in r["calls"])
        d = cfg.head_dim_
        one = 2.0 * rows * 16 * 16 * 2 * d     # a head, a launch
        want = cfg.n_layers * r["accum"] * 2 * hl * one
        assert len(r["calls"]) == cfg.n_layers * r["accum"] * 2
        assert got == want, (arch, got, want)
        assert got / (cfg.n_layers * r["accum"] * 2 * h * one) == hl / h


@pytest.mark.parametrize("mesh", list(MESHES_SMALL))
def test_ce_chunk_count_has_no_vocab_gather(partitioned, mesh):
    """One cross-entropy chunk of every family's smoke train cell on the
    fake meshes, where ``model`` splits the vocab: no all-gather; the
    log-sum-exp's row max and row sum, 2 x rows x (S / chunks) x 4 B of
    all-reduce (rows: the batch over the data axes; S: the labelled
    positions).  The smoke batch is 32 rows of 16 positions."""
    shape, names = MESHES_SMALL[mesh]
    data = math.prod(shape) // shape[names.index("model")]
    for key, r in partitioned[mesh].items():
        if not key.endswith(("/train", "/padded")):
            continue
        cfg = tcfgs.get_smoke_config(key.split("/")[0])
        s = tcfgs.input_specs(cfg, tcfgs.Shape("smoke", 16, 32, "train"))[
            "labels"].shape[1]              # a vision prefix takes some
        chunks = cfg.logit_chunks if s % cfg.logit_chunks == 0 else 1
        ce = r["ce"]
        assert ce.get("all-gather", 0.0) == 0.0, (key, ce)
        if mesh == "data_model":
            assert ce == {"all-reduce": 2 * (32 // data) * (s // chunks)
                          * 4.0}, (key, ce)
        else:
            assert set(ce) == {"all-reduce"}, (key, ce)


@pytest.mark.parametrize("mesh", list(MESHES_SMALL))
def test_partitioned_pass_counts_every_microbatch(partitioned, mesh):
    """nemotron-4-340b's smoke train step (32 rows of 16) at 8 and 16
    microbatches counts every one.  On (2, 4) a device runs 16 rows
    either way (2 a microbatch or 1), so the matmul FLOPs are equal; on
    a pod's slice of (2, 2, 2) the pod's 16 rows in 16 microbatches of 1
    row, which ``data`` 2 does not divide, run padded to 2
    (``sharding.split_rows``), one row a device, twice the rows of the 8
    microbatches of 2: twice the matmul FLOPs, as XLA's padded split
    computes.  The batch is re-laid out by all-to-alls.  (The count at 8
    is the padded-heads case's.)"""
    at8 = partitioned[mesh]["nemotron-4-340b/padded"]
    at16 = partitioned[mesh]["uneven"]
    assert (at8["accum"], at16["accum"]) == (8, 16)
    ratio = at16["flops"]["matmul"] / at8["flops"]["matmul"]
    assert ratio == (1.0 if mesh == "data_model" else 2.0)
    assert at16["collectives"].get("all-to-all", 0) > 0


def test_shard_to_shard_counts_as_all_to_all(partitioned):
    """The Adafactor update of qwen2.5-32b's stacked FFN weight (64
    layers, at 512 x 2048 for 5120 x 27648; the FSDP split over ``data``,
    the columns over ``model``) on the fake (2, 4) mesh, where DTensor
    re-lays out the FSDP split onto the layer dim and back (three calls a
    stacked FFN weight: the 9 Shard-to-Shard redistributes of each of
    qwen2.5-32b's and llava-next-34b's ``train_4k`` cells): each counts
    one all-to-all of max(operand, result), as NCCL sends it.  Counted
    as DTensor's CPU route runs it (the profiler's rule switched off),
    each was an all-gather of the mesh dim's whole (m x the operand) and
    a chunk."""
    r = partitioned["data_model"]["s2s"]
    calls, counted, fallback = r["calls"], r["counted"], r["fallback"]
    assert len(calls) == 3 and r["fallback_calls"] == calls
    moved = sum(max(a, b) for a, b, _ in calls)
    gathered = sum(m * a for a, _, m in calls)
    assert counted["all-to-all"] - fallback.get("all-to-all", 0) == moved
    assert fallback["all-gather"] - counted.get("all-gather", 0) == gathered
    assert {k: v for k, v in counted.items()
            if k not in ("all-to-all", "all-gather")} == {
        k: v for k, v in fallback.items()
        if k not in ("all-to-all", "all-gather")}
    # the count's tally (a dry-run record's ``shard_to_shard``): the calls
    # and their bytes, and no collective counted inside DTensor's CPU
    # route, which the route's own count shows, one all-gather a call
    assert r["tally"][0] == {"calls": 3, "bytes": moved,
                             "fallback_collectives": 0}
    assert r["tally"][1] == {"calls": 0, "bytes": 0.0,
                             "fallback_collectives": 3}


def test_plain_count_has_no_collectives():
    cell = _smoke_train_cell("stablelm-1.6b")
    c = count_step(*_train_args(cell))
    assert c.collectives == {}
    assert c.flops == flops_by_category(*_train_args(cell))
    assert c.bytes == traffic_bytes(*_train_args(cell))
