"""The port's mesh, partition-spec trees and sharding helpers
(``repro_torch.models.params``, ``distributed.{compat,specs,sharding}``,
``launch.mesh``, ``data.pipeline.make_batch_sharding``,
``checkpoint.manager``'s ``shardings=``) against the reference.

* The spec trees are plain data and equal the reference's
  ``PartitionSpec`` trees leaf for leaf: ``param_pspecs`` for all ten
  archs at (fsdp 16, tp 16), (0, 16) and (0, 4); ``param_shape_structs``
  in shapes and dtypes; ``batch_pspecs``, ``cache_pspecs`` and
  ``opt_pspecs`` on the shape trees of every dry-run cell.
* Off a mesh the helpers do what the reference's do: ``constrain`` is the
  identity, ``logical_to_mesh`` and ``batch_axes`` give None.
* On a mesh: one launch of 8 gloo processes (``sys.executable`` children
  that import torch and ``repro_torch`` only, one thread each, meeting
  through a ``FileStore`` under the test's temporary directory, at the
  default CPU priority: at the lowest one they got only the CPU the
  machine's other test workers left, and under the whole suite ran past
  their time limit) serves every multi-rank assert of this file.  No process group or
  ``DeviceMesh`` is created in the pytest process.  On a (2, 4)
  ``(data, model)`` mesh the smoke qwen2-72b takes one AdamW step with
  params, optimizer state and batch distributed by ``param_pspecs(fsdp 0,
  tp 4)``, ``opt_pspecs`` and ``batch_pspecs``, mirroring
  ``tests/test_distributed.py``: the mesh's names are current inside the
  step, the loss is within the reference test's 5e-2 of the port's
  unmeshed step and of the reference's one-device step on the same
  weights, its gradient norm and updated parameters equal the port's
  unmeshed step's, and the parameters keep their placements.  A checkpoint saved
  replicated comes back through ``restore_latest(..., shardings=)``
  bit-equal on every rank with the requested placements (mirroring
  ``tests/test_system.py::test_elastic_checkpoint_restore_new_sharding``),
  ``make_batch_sharding`` gives the reference's axes, and the flash
  attention's wrapper on DTensors equals its result on whole tensors.
  qwen2-moe-a2.7b's smoke model serves on the mesh as it does unmeshed.
  qwen2.5-32b's smoke model (5 query heads over ``model`` 4, run padded
  to 8) and deepseek-v3-671b's with 3 MLA heads (padded to 4) take the
  float32 step as they do unmeshed, and one
  cross-entropy chunk on a vocab split over ``model`` (its log-sum-exp
  on each device's shard) equals the unmeshed chunk.  A float32 step of
  6 rows in 2 microbatches, which ``data`` 2 does not divide, runs padded
  as the unmeshed step runs it whole (qwen2-72b, and qwen2-moe-a2.7b
  whose load-balance loss leaves the pads out); rows split over (pod,
  data) of a (2, 2, 2) mesh pad alike; a Shard-to-Shard redistribute
  counts as one all-to-all.
  Rank 0 counts the collective bytes of the meshed training step, the
  MoE prefill and decode step, xlstm-125m's training step (its mLSTM
  replicated over ``model``, as the reference's), the padded steps and
  the uneven-microbatch steps on real tensors; each equals the dry
  run's partitioned pass of the same cell on meta shards over a fake
  group of 8 ranks, by kind, exactly.  That pass runs in a ninth process
  beside the ranks; the launch has CHILD_TIMEOUT seconds from its start.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jcfgs
from repro.distributed import sharding as jsharding
from repro.distributed import specs as jspecs
from repro.models import LM as JLM
from repro.models import init_params as jinit
from repro.models import params as jparams
from repro.optim import adamw as jadamw
from repro.train import make_train_step as jmake_train_step
from repro_torch import configs as tcfgs
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import compat as tcompat
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed import specs as tspecs
from repro_torch.launch import dryrun as tdry
from repro_torch.models import LM
from repro_torch.models import params as tparams
from repro_torch.models.params import leaves
from repro_torch.optim import adafactor, adamw
from repro_torch.train import loss_and_grads, make_train_step

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LAYOUTS = [(16, 16), (0, 16), (0, 4)]
MESH_AXES = {"single": ("data", "model"), "multi": ("pod", "data", "model")}
WORLD = 8
# the padded steps, as the child script's ``PADDED``: arch -> its query
# heads (None: the smoke config's)
PADDED = {"qwen2.5-32b": None, "deepseek-v3-671b": 3}
# the uneven-microbatch steps, as the child script's ``UNEVEN``: 6 rows in
# 2 microbatches of 3 over ``data`` 2
UNEVEN = ("qwen2-72b", "qwen2-moe-a2.7b")
UNEVEN_ROWS, UNEVEN_ACCUM = 6, 2
# the whole launch's seconds: the children take ~40 s on an idle 8-core
# machine and a few times that beside the whole suite's workers
CHILD_TIMEOUT = 480


def _is_p(x):
    return isinstance(x, P)


def _ref_leaves(tree):
    """(path, leaf) of a reference tree, PartitionSpecs as leaves, in
    ``jax.tree_util`` order."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_p)[0]
    return [(tuple(k.key for k in path), leaf) for path, leaf in flat]


def _assert_same_specs(got, want):
    want_l = _ref_leaves(want)
    got_l = list(leaves(got))
    assert [p for p, _ in got_l] == [p for p, _ in want_l]
    for (path, g), (_, w) in zip(got_l, want_l):
        assert isinstance(g, tuple), path
        assert g == tuple(w), (path, g, w)


def _sds(tree):
    """A port tree of tensors as the reference's shape stand-ins."""
    return tparams.map_tree(
        lambda t: jax.ShapeDtypeStruct(
            tuple(t.shape), jnp.dtype(str(t.dtype).replace("torch.", ""))),
        tree)


# --- the spec trees ----------------------------------------------------------


@pytest.mark.parametrize("fsdp,tp", LAYOUTS)
@pytest.mark.parametrize("arch", list(tcfgs.ARCHS))
def test_param_pspecs_equal_reference(arch, fsdp, tp):
    want = jparams.param_pspecs(jcfgs.get_config(arch), fsdp_size=fsdp,
                                tp_size=tp)
    got = tparams.param_pspecs(tcfgs.get_config(arch), fsdp_size=fsdp,
                               tp_size=tp)
    _assert_same_specs(got, want)


@pytest.mark.parametrize("arch", list(tcfgs.ARCHS))
def test_param_shape_structs_equal_reference(arch):
    want = jax.tree_util.tree_flatten_with_path(
        jparams.param_shape_structs(jcfgs.get_config(arch)))[0]
    got = list(leaves(tparams.param_shape_structs(tcfgs.get_config(arch))))
    assert len(got) == len(want)
    for (path, t), (jpath, s) in zip(got, want):
        assert path == tuple(k.key for k in jpath)
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(s.shape), path
        assert str(t.dtype) == f"torch.{s.dtype}", path


def test_every_template_carries_its_axes():
    """No template leaf of any arch is left without a spec of its rank."""
    for arch in tcfgs.ARCHS:
        for path, spec in leaves(tparams.model_templates(
                tcfgs.get_config(arch))):
            assert spec.pspec is not None, (arch, path)
            assert len(spec.pspec) == len(spec.shape), (arch, path)


def test_fsdp_pspecs_divisible():
    """``tests/test_models.py::test_fsdp_pspecs_divisible``."""
    cfg = tcfgs.get_config("qwen2-72b")
    ps = dict(leaves(tparams.param_pspecs(cfg, fsdp_size=16, tp_size=16)))
    for path, leaf in leaves(tparams.param_shape_structs(cfg)):
        for dim, ax in zip(leaf.shape, ps[path] + (None,) * 8):
            if ax in ("model", "data"):
                assert dim % 16 == 0, (leaf.shape, ps[path])


def _cell_trees(arch, shape_name):
    """The port's shape trees of one dry-run cell: (batch, cache or None,
    optimizer state or None), on ``meta``."""
    cfg = tcfgs.get_config(arch)
    sh = tcfgs.SHAPES[shape_name]
    model = LM(cfg)
    batch = tcfgs.input_specs(cfg, sh)
    cache = opt_state = None
    if sh.kind == "train":
        opt = (adafactor(1e-4) if arch in tdry.ADAFACTOR_ARCHS
               else adamw(1e-4))
        opt_state = opt.init(tparams.param_shape_structs(cfg))
    else:
        # a prefill's cache is a decode cache of max_len = S + 128 plus,
        # for an encoder-decoder, the encoder memory
        length = sh.seq_len + (128 if sh.kind == "prefill" else 0)
        cache = model.init_cache(sh.global_batch, length, device="meta")
        if cfg.is_encdec:
            frames = (batch["frames"].shape[1] if sh.kind == "prefill"
                      else 4096)
            cache["enc_out"] = torch.empty(
                (sh.global_batch, frames, cfg.d_model),
                dtype=cfg.activation_dtype, device="meta")
    return cfg, sh, batch, cache, opt_state


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch,shape_name", tdry.all_cells())
def test_batch_cache_opt_pspecs_equal_reference(arch, shape_name, mesh):
    axes = MESH_AXES[mesh]
    cfg, sh, batch, cache, opt_state = _cell_trees(arch, shape_name)
    _assert_same_specs(tspecs.batch_pspecs(batch, axes),
                       jspecs.batch_pspecs(_sds(batch), axes))
    if cache is not None:
        _assert_same_specs(
            tspecs.cache_pspecs(cfg, cache, axes, 16, sh.global_batch),
            jspecs.cache_pspecs(jcfgs.get_config(arch), _sds(cache), axes,
                                16, sh.global_batch))
    if opt_state is not None:
        fsdp = 16 if cfg.param_dtype == "bfloat16" else 0
        got = tspecs.opt_pspecs(opt_state, tparams.param_pspecs(
            cfg, fsdp_size=fsdp, tp_size=16))
        want = jspecs.opt_pspecs(_sds(opt_state), jparams.param_pspecs(
            jcfgs.get_config(arch), fsdp_size=fsdp, tp_size=16))
        _assert_same_specs(got, want)


# --- off a mesh --------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    (("pod", "data"), None, "model"), ("data", "model"), ("pod",),
    (None, ("pod",), "model", "data")])
def test_filter_spec_equals_reference(spec):
    for axes in MESH_AXES.values():
        got = tuple(tsharding._filter_spec(s, axes) for s in spec)
        want = tuple(jsharding._filter_spec(s, axes) for s in spec)
        assert got == want


def test_off_mesh_helpers_are_identity():
    """The reference's helpers off a mesh: no axis names, ``constrain``
    the identity (the same tensor back), no batch axes; the residual
    constraint the identity in every mode."""
    assert tcompat.current_mesh() is None
    assert tcompat.current_mesh_axis_names() == ()
    assert tsharding.current_axis_names() == ()
    assert tsharding.logical_to_mesh((("pod", "data"), None)) is None
    assert tsharding.batch_axes() is None
    x = torch.randn(32, 16, 8)
    assert tsharding.constrain(x, ("pod", "data"), None, "model") is x
    for mode in ("baseline", "dp", "sp"):
        os.environ["REPRO_ACT_SHARDING"] = mode
        try:
            assert tsharding.activation_sharding_mode() == \
                jsharding.activation_sharding_mode() == mode
            assert tsharding.constrain_residual(x) is x
        finally:
            del os.environ["REPRO_ACT_SHARDING"]
    assert tsharding.activation_sharding_mode() == "baseline"


def test_placements_follow_the_spec():
    """A spec maps to DTensor placements by mesh dim name: a dim over
    (pod, data) is sharded on both, a name the mesh lacks is dropped."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(ndim=3,
                                 mesh_dim_names=("pod", "data", "model"))
    assert tsharding.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert tsharding.placements((None, "model"), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    mesh2 = types.SimpleNamespace(ndim=2, mesh_dim_names=("data", "model"))
    assert tsharding.placements((("pod", "data"), "expert"), mesh2) == [
        Shard(0), Replicate()]


# --- on a mesh: 8 gloo processes ---------------------------------------------

_CHILD = r'''
import dataclasses, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

WORLD = 8
AXES = ("data", "model")
# the padded steps: arch -> its query heads (None: the smoke config's);
# qwen2.5-32b's 5 GQA heads over ``model`` 4 pad to 8, deepseek-v3-671b's
# MLA with 3 heads to 4
PADDED = {"qwen2.5-32b": None, "deepseek-v3-671b": 3}
# the steps whose 6 rows in 2 microbatches of 3 ``data`` 2 does not
# divide: a dense and a MoE smoke model
UNEVEN = ("qwen2-72b", "qwen2-moe-a2.7b")


def nest(flat):
    tree = {}
    for key in flat.files:
        if key.startswith("__"):
            continue
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = flat[key]
    return tree


def whole(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def train_cell(weights, arch, dtype=None, heads=None):
    # a smoke model's weights and batch (from ``weights``), its model,
    # AdamW, the optimizer state and the trees' layouts on the mesh;
    # ``heads``: the query heads, where the smoke config's are replaced
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed.specs import batch_pspecs, opt_pspecs
    from repro_torch.models import LM
    from repro_torch.models.params import param_pspecs
    from repro_torch.optim import adamw
    flat = np.load(weights)
    cfg = get_smoke_config(arch)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if heads is not None:
        cfg = dataclasses.replace(cfg, n_heads=heads)
    params = lm_params_from_numpy(nest(flat), cfg, device="cpu")
    batch = {k: torch.from_numpy(flat["__" + k]).to(torch.int64)
             for k in ("tokens", "labels")}
    opt = adamw(1e-3)
    state = opt.init(params)
    pps = param_pspecs(cfg, fsdp_size=0, tp_size=4)
    specs = (pps, opt_pspecs(state, pps),
             batch_pspecs(batch, AXES, dp_total=2))
    return cfg, LM(cfg), opt, (params, state, batch), specs


def grads_step(model, opt):
    # what the train step computes before its update: (loss, gradient
    # norm, gradients), under mesh_ops
    from repro_torch.distributed.sharding import mesh_ops
    from repro_torch.train import loss_and_grads

    def f(params, state, batch):
        with mesh_ops():
            loss, _, grads = loss_and_grads(model, params, batch)
            _, _, om = opt.update(grads, state, params, 0)
        return loss, om["grad_norm"], grads
    return f


def moe_cell(weights):
    # qwen2-moe-a2.7b's smoke model at float32 activations, its weights
    # cast for serving, the tokens, the prompt length, and the cache of
    # an unmeshed prefill laid out by cache_pspecs (the dry run's decode
    # cell)
    from repro_torch.configs import get_smoke_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.distributed.specs import cache_pspecs
    from repro_torch.models import LM
    from repro_torch.models.params import compute_params
    flat = np.load(weights)
    cfg = dataclasses.replace(get_smoke_config("qwen2-moe-a2.7b"),
                              dtype="float32")
    params = compute_params(cfg, lm_params_from_numpy(nest(flat), cfg,
                                                      device="cpu"))
    toks = torch.from_numpy(flat["__tokens"]).to(torch.int64)
    s = 12
    model = LM(cfg)
    cache, _ = model.prefill(params, {"tokens": toks[:, :s]}, max_len=s + 8)
    c_ps = cache_pspecs(cfg, cache, AXES, 4, toks.shape[0])
    return cfg, model, params, toks, s, cache, c_ps


def recurrent_cell():
    # xlstm-125m's smoke training step, its trees and their layouts
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.specs import batch_pspecs, opt_pspecs
    from repro_torch.models import LM, init_params
    from repro_torch.models.params import param_pspecs
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    cfg = get_smoke_config("xlstm-125m")
    params = init_params(cfg, device="cpu")
    opt = adamw(1e-3)
    state = opt.init(params)
    toks = torch.randint(0, cfg.vocab_size, (8, 17),
                         generator=torch.Generator().manual_seed(3))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    pps = param_pspecs(cfg, fsdp_size=0, tp_size=4)
    specs = (pps, opt_pspecs(state, pps),
             batch_pspecs(batch, AXES, dp_total=2))
    return make_train_step(LM(cfg), opt), (params, state, batch), specs


def run(rank, out_dir, weights, moe_weights, *rest):
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.profiler import count_step
    from repro_torch.data.pipeline import make_batch_sharding
    from repro_torch.distributed.compat import (current_mesh_axis_names,
                                                enter_mesh)
    from repro_torch.distributed.sharding import (
        batch_axes, constrain, current_axis_names, distribute_tree,
        logical_to_mesh, mesh_ops)
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import LM, layers
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.optim.base import apply_updates
    from repro_torch.train import loss_and_grads, make_train_step

    out, walls = {}, {}
    t0 = time.perf_counter()
    cfg, model, opt, trees, specs = train_cell(weights, "qwen2-72b")
    step = make_train_step(model, opt)
    mesh = make_test_mesh((2, 4), AXES)
    enter_mesh(mesh)
    dparams, dstate, dbatch = (distribute_tree(t, sp, mesh)
                               for t, sp in zip(trees, specs))
    seen = {"calls": 0}
    on_shards = ops._on_shards

    def spy(q, k, v, **kw):
        seen["calls"] += 1
        seen["axes"] = list(current_axis_names())
        return on_shards(q, k, v, **kw)

    ops._on_shards = spy
    lse_calls = layers._VocabParallelLSE.calls
    # the step, counted on this rank's real tensors: its collective bytes
    # by kind (rank 0's are held to the meta pass over a fake group)
    counted = count_step(step, dparams, dstate, dbatch, 0)
    ops._on_shards = on_shards
    p2, s2, m2 = counted.out
    out["step_collectives"] = counted.collectives
    out["vocab_parallel_lse_in_step"] = (layers._VocabParallelLSE.calls
                                         - lse_calls)
    out["axes_in_step"] = seen.get("axes")
    out["attention_on_shards"] = seen["calls"]
    out["loss_meshed"] = float(m2["loss"])
    walls["step"] = time.perf_counter() - t0

    # the step's gradients with float32 activations, where the mesh
    # changes only the order of sums: its loss and gradient norm; its
    # gradients, whole (every rank gathers; rank 0 keeps them); and
    # AdamW's update on the DTensors against the same update on the
    # gathered trees
    t0 = time.perf_counter()
    model32 = LM(dataclasses.replace(cfg, dtype="float32"))
    with mesh_ops():
        l32, _, g32 = loss_and_grads(model32, dparams, dbatch)
        upd, _, om = opt.update(g32, dstate, dparams, 0)
        got = apply_updates(dparams, upd)
    out["loss_meshed_f32"] = float(whole(l32))
    out["grad_norm_meshed_f32"] = float(whole(om["grad_norm"]))
    full = lambda tree: map_tree(lambda t: t.full_tensor(), tree)
    g32, got = full(g32), full(got)
    wparams = full(dparams)
    upd, _, _ = opt.update(g32, full(dstate), wparams, 0)
    want = apply_updates(wparams, upd)
    out["update_err"] = max(float((a - b).abs().max()
                                  / b.abs().max().clamp(min=1e-30))
                            for (_, a), (_, b)
                            in zip(leaves(got), leaves(want)))
    if rank == 0:
        np.savez(os.path.join(out_dir, "meshed_grads.npz"),
                 **{"/".join(path): t.numpy() for path, t in leaves(g32)})
    same = lambda a, b: all(
        isinstance(y, DTensor) and tuple(x.placements) == tuple(y.placements)
        for (_, x), (_, y) in zip(leaves(a), leaves(b)))
    out["params_keep_placements"] = same(dparams, p2)
    out["opt_keeps_placements"] = same(dstate["m"], s2["m"]) and same(
        dstate["v"], s2["v"])
    out["sharded_leaves"] = sum(
        any(isinstance(pl, Shard) for pl in t.placements)
        for _, t in leaves(p2))
    walls["step_f32"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    bmesh, bpl = make_batch_sharding(mesh)
    out["batch_sharding_axes"] = [mesh.mesh_dim_names[i]
                                  for i, pl in enumerate(bpl)
                                  if pl == Shard(0)]
    out["batch_axes"] = list(batch_axes())
    out["logical_to_mesh"] = logical_to_mesh(
        (("pod", "data"), "model", None, "pod"))
    x = distribute_tensor(torch.arange(32.).reshape(8, 4), mesh,
                          [Replicate(), Replicate()])
    y = constrain(x, ("pod", "data"), "model")
    out["constrain_placements"] = [str(pl) for pl in y.placements]
    out["constrain_equal"] = bool(torch.equal(y.full_tensor(),
                                              x.full_tensor()))

    # the flash attention's wrapper on DTensors against whole tensors,
    # forward and gradients: heads split alike; KV heads replicated (a
    # shard then holds part of one group, or straddles two); batch
    # sharded; q replicated
    cases = [(8, 4, [Shard(0), Shard(1)], [Shard(0), Shard(1)]),
             (8, 2, [Replicate(), Shard(1)], [Replicate(), Replicate()]),
             (8, 1, [Shard(0), Shard(1)], [Shard(0), Replicate()]),
             (12, 6, [Replicate(), Shard(1)], [Replicate(), Replicate()]),
             (4, 4, [Shard(0), Replicate()], [Replicate(), Replicate()])]
    g = torch.Generator().manual_seed(0)
    errs = []
    for hq, hkv, q_pl, kv_pl in cases:
        q = torch.randn(4, hq, 16, 8, generator=g)
        k = torch.randn(4, hkv, 16, 8, generator=g)
        v = torch.randn(4, hkv, 16, 8, generator=g)
        leaf = [t.clone().requires_grad_() for t in (q, k, v)]
        want = ops.gqa_flash_attention(*leaf)
        want.square().sum().backward()
        dq = distribute_tensor(q, mesh, q_pl).requires_grad_()
        dk = distribute_tensor(k, mesh, kv_pl).requires_grad_()
        dv = distribute_tensor(v, mesh, kv_pl).requires_grad_()
        got = ops.gqa_flash_attention(dq, dk, dv)
        keep = [str(pl) for pl in got.placements]
        got.full_tensor().square().sum().backward()
        # beyond rtol 1e-5: the KV gradients are summed over the ranks
        excess = lambda a, b: float(((a - b).abs() - 1e-5 * b.abs()).max())
        err = excess(got.full_tensor().detach(), want.detach())
        for a, b in zip((dq, dk, dv), leaf):
            err = max(err, excess(a.grad.full_tensor(), b.grad))
        errs.append({"err": err, "placements": keep})
    out["attention_cases"] = errs

    ckpt = CheckpointManager(os.path.join(out_dir, "ckpt"))
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "b": torch.arange(8, dtype=torch.float32) * 0.5}
    if rank == 0:
        ckpt.save(3, tree)
    dist.barrier()
    want_pl = {"w": [Shard(0), Shard(1)], "b": [Replicate(), Shard(0)]}
    got_step, restored = ckpt.restore_latest(
        tree, shardings={k: (mesh, pl) for k, pl in want_pl.items()})
    d, m = mesh.get_coordinate()
    out["ckpt_step"] = got_step
    out["ckpt_placements"] = all(
        isinstance(restored[k], DTensor)
        and list(restored[k].placements) == want_pl[k] for k in tree)
    out["ckpt_local_equal"] = bool(
        torch.equal(restored["w"].to_local(),
                    tree["w"][4 * d:4 * d + 4, 2 * m:2 * m + 2])
        and torch.equal(restored["b"].to_local(), tree["b"][2 * m:2 * m + 2]))
    out["ckpt_whole_equal"] = all(
        torch.equal(restored[k].full_tensor(), tree[k]) for k in tree)
    ce_chunk(mesh, out)
    walls["helpers"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_serving(rank, mesh, out, out_dir, moe_weights)
    walls["moe"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    recurrent_step(mesh, out)
    walls["recurrent"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pad_weights, uneven_weights = rest[:len(PADDED)], rest[len(PADDED):]
    for arch, w in zip(PADDED, pad_weights):
        padded_step(rank, mesh, out, out_dir, w, arch)
    walls["padded"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for arch, w in zip(UNEVEN, uneven_weights):
        uneven_step(rank, mesh, out, out_dir, w, arch)
    shard_to_shard(mesh, out)
    rows_over_pods(out)
    walls["uneven"] = time.perf_counter() - t0
    enter_mesh(None)
    out["axes_after_leaving"] = list(current_mesh_axis_names())
    return out, walls


def ce_chunk(mesh, out):
    # one cross-entropy chunk at float32 on vocab-split logits (the head
    # split over ``model``, padded vocab columns, ignored labels) against
    # the same chunk unmeshed: its loss and the gradients of the hidden
    # state and the head; the chunk's collectives by kind, counted
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.core.profiler import count_step
    from repro_torch.distributed.sharding import mesh_ops
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4, 6, 16, generator=g)
    hw = torch.randn(24, 16, generator=g)
    lab = torch.randint(0, 21, (4, 6), generator=g)
    lab[1, 2] = lab[3, 0] = -1
    leaf = [t.clone().requires_grad_() for t in (x, hw)]
    tot, cnt = layers._ce_chunk(leaf[0], lab, leaf[1], 21)
    tot.backward()
    dx = distribute_tensor(x, mesh, [Shard(0), Replicate()]).requires_grad_()
    dhw = distribute_tensor(hw, mesh, [Replicate(), Shard(0)]
                            ).requires_grad_()
    dl = distribute_tensor(lab, mesh, [Shard(0), Replicate()])
    calls = layers._VocabParallelLSE.calls
    with mesh_ops():
        counted = count_step(layers._ce_chunk, dx, dl, dhw, 21)
        got, n = counted.out
        whole(got).backward()
    out["ce_vocab_parallel_calls"] = layers._VocabParallelLSE.calls - calls
    out["ce_collectives"] = counted.collectives
    out["ce_loss"] = [float(whole(got)), float(tot)]
    out["ce_count"] = [float(whole(n)), float(cnt)]
    out["ce_grad_err"] = max(
        float((a.grad.full_tensor() - b.grad).abs().max()
              / b.grad.abs().max()) for a, b in zip((dx, dhw), leaf))


def moe_serving(rank, mesh, out, out_dir, weights):
    # qwen2-moe-a2.7b's smoke model at float32 activations: a prefill of
    # 32 x 12 tokens and 3 decode steps, unmeshed and on the mesh (params,
    # tokens and cache DTensors); rank 0 keeps the meshed logits.  The
    # meshed prefill, and a decode step from the prefill's cache laid out
    # by cache_pspecs (the dry run's decode cell), counted: their
    # collective bytes by kind.
    from torch.distributed.tensor import DTensor
    from repro_torch.core.profiler import count_step
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.distributed.specs import batch_pspecs
    from repro_torch.models.params import leaves, param_pspecs

    cfg, model, params, toks, s, cache0, c_ps = moe_cell(weights)
    steps = toks.shape[1] - s

    def serve(p, t):
        counted = count_step(model.prefill, p, {"tokens": t[:, :s]},
                             max_len=s + 8)
        cache, lg = counted.out
        logits = [lg]
        for i in range(steps):
            lg, cache = model.decode_step(p, cache, t[:, s + i:s + i + 1])
            logits.append(lg)
        return logits, cache, counted.collectives

    want, want_cache, _ = serve(params, toks)
    dparams = distribute_tree(params, param_pspecs(cfg, fsdp_size=0,
                                                   tp_size=4), mesh)
    dtoks = distribute_tree({"tokens": toks}, batch_pspecs(
        {"tokens": toks}, AXES), mesh)["tokens"]
    got, got_cache, out["moe_prefill_collectives"] = serve(dparams, dtoks)
    got = [whole(g) for g in got]
    out["moe_logits_err"] = max(float((g - w).abs().max() / w.abs().max())
                                for g, w in zip(got, want))
    out["moe_cache_err"] = max(
        float((whole(a).float() - b.float()).abs().max())
        for (_, a), (_, b) in zip(leaves(got_cache), leaves(want_cache)))
    out["moe_cache_dtensors"] = sum(isinstance(t, DTensor)
                                    for _, t in leaves(got_cache))
    out["moe_logits_placements"] = [str(p) for p in dtoks.placements]
    if rank == 0:
        np.save(os.path.join(out_dir, "moe_logits.npy"),
                torch.stack(got).numpy())
    out["moe_decode_collectives"] = count_step(
        model.decode_step, dparams, distribute_tree(cache0, c_ps, mesh),
        dtoks[:, s:s + 1]).collectives


def recurrent_step(mesh, out):
    # xlstm-125m's smoke training step on the mesh (the mLSTM's weights
    # replicated, as the reference's), counted: its collective bytes by
    # kind.  Its
    # time loops run step by step here; on ``meta`` one step stands for
    # the rest (``core.profiler.repeated``).
    from repro_torch.core.profiler import count_step
    from repro_torch.distributed.sharding import distribute_tree
    step, trees, specs = recurrent_cell()
    args = [distribute_tree(t, sp, mesh) for t, sp in zip(trees, specs)]
    out["recurrent_collectives"] = count_step(step, *args, 0).collectives


def padded_step(rank, mesh, out, out_dir, weights, arch):
    # ``arch``'s smoke model (``PADDED``) at float32 activations, its
    # query heads over ``model`` 4 padded; the gradients of its train
    # step counted (collective bytes by kind) and gathered whole (rank 0
    # keeps them)
    from repro_torch.core.profiler import count_step
    from repro_torch.distributed import sharding
    from repro_torch.models.params import leaves, map_tree
    cfg, model, opt, trees, specs = train_cell(weights, arch, "float32",
                                               PADDED[arch])
    args = [sharding.distribute_tree(t, sp, mesh)
            for t, sp in zip(trees, specs)]
    pads = sharding._PadHeads.calls
    counted = count_step(grads_step(model, opt), *args)
    loss, norm, grads = counted.out
    out["padded/" + arch] = {
        "pad_calls": sharding._PadHeads.calls - pads,
        "collectives": counted.collectives,
        "loss_f32": float(whole(loss)),
        "grad_norm_f32": float(whole(norm))}
    grads = map_tree(lambda t: t.full_tensor(), grads)
    if rank == 0:
        np.savez(os.path.join(out_dir, f"padded_grads_{arch}.npz"),
                 **{"/".join(path): t.numpy() for path, t in leaves(grads)})


def spied(opt, seen):
    # ``opt`` whose update keeps the gradients it is handed in ``seen``
    from repro_torch.optim.base import Optimizer

    def update(grads, state, params, step):
        seen["grads"] = grads
        return opt.update(grads, state, params, step)
    return Optimizer(opt.init, update)


def uneven_step(rank, mesh, out, out_dir, weights, arch):
    # ``arch``'s smoke model (``UNEVEN``) at float32 activations on 6
    # rows in 2 microbatches of 3, which ``data`` 2 does not divide (each
    # padded to 4): the train step counted (collective bytes by kind), its
    # loss and gradient norm, and the gradients it hands the optimizer
    # gathered whole (rank 0 keeps them)
    from repro_torch.core.profiler import count_step
    from repro_torch.distributed import sharding
    from repro_torch.models.params import leaves, map_tree
    from repro_torch.train import make_train_step
    cfg, model, opt, trees, specs = train_cell(weights, arch, "float32")
    seen = {}
    step = make_train_step(model, spied(opt, seen), accum_steps=2)
    args = [sharding.distribute_tree(t, sp, mesh)
            for t, sp in zip(trees, specs)]
    counted = count_step(step, *args, 0)
    m = counted.out[2]
    out["uneven/" + arch] = {
        "collectives": counted.collectives,
        "rows": [list(mb.to_local().shape) for mb in
                 sharding.split_rows(args[2]["tokens"], 2)],
        "loss_f32": float(whole(m["loss"])),
        "grad_norm_f32": float(whole(m["grad_norm"]))}
    grads = map_tree(lambda t: t.full_tensor(), seen["grads"])
    if rank == 0:
        np.savez(os.path.join(out_dir, f"uneven_grads_{arch}.npz"),
                 **{"/".join(path): t.numpy() for path, t in leaves(grads)})


def shard_to_shard(mesh, out):
    # a Shard-to-Shard redistribute over ``model`` (rows to columns),
    # counted: one all-to-all of the shard (DTensor's gloo route is an
    # all-gather and a chunk, which the count does not see)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.core.profiler import count_step
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    dx = distribute_tensor(x, mesh, [Replicate(), Shard(0)])
    counted = count_step(dx.redistribute, mesh, [Replicate(), Shard(1)])
    out["s2s_collectives"] = counted.collectives
    out["s2s_placements"] = [str(p) for p in counted.out.placements]
    out["s2s_equal"] = bool(torch.equal(counted.out.full_tensor(), x))


def rows_over_pods(out):
    # a batch of 12 rows split over (pod, data) of a (2, 2, 2) mesh, in 2
    # and in 4 microbatches of 6 and 3 rows (padded to 8 and 4 over the 4
    # data devices): each microbatch's rows, the pads -1, gathered whole
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed.sharding import split_rows
    from repro_torch.launch.mesh import make_test_mesh
    mesh = make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(36).reshape(12, 3)
    dx = distribute_tensor(x, mesh, [Shard(0), Shard(0), Replicate()])
    out["rows_over_pods"] = {
        accum: [[list(m.to_local().shape), m.full_tensor().tolist()]
                for m in split_rows(dx, accum, -1)] for accum in (2, 4)}


def meta_counts(out_dir, weights, moe_weights, *rest):
    # the counted steps' collective bytes by kind from the dry run's
    # partitioned pass: the same steps and layouts on meta shards over a
    # fake group of the same 8 ranks, rank 0's view; in a process of its
    # own, beside the ranks
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.distributed.specs import batch_pspecs
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.params import map_tree, param_pspecs
    from repro_torch.train import make_train_step

    on_meta = lambda tree: map_tree(lambda t: torch.empty(
        t.shape, dtype=t.dtype, device="meta"), tree)

    def cell(fn, trees, specs, *step):
        # ``step``: the train step's step number, an argument no spec lays
        return dryrun.Cell(fn, tuple(on_meta(t) for t in trees) + step,
                           tuple(specs) + (None,) * len(step), None, (0, 1),
                           None, None, 1)

    pad_weights, uneven_weights = rest[:len(PADDED)], rest[len(PADDED):]
    _, model, opt, trees, specs = train_cell(weights, "qwen2-72b")
    cells = {"train": cell(make_train_step(model, opt), trees, specs, 0)}
    for arch, w in zip(UNEVEN, uneven_weights):
        _, umodel, uopt, utrees, uspecs = train_cell(w, arch, "float32")
        cells["uneven/" + arch] = cell(
            make_train_step(umodel, uopt, accum_steps=2), utrees, uspecs, 0)
    for arch, w in zip(PADDED, pad_weights):
        _, pmodel, popt, ptrees, pspecs = train_cell(w, arch, "float32",
                                                     PADDED[arch])
        cells["padded/" + arch] = cell(grads_step(pmodel, popt), ptrees,
                                       pspecs)
    step, rtrees, rspecs = recurrent_cell()
    cells["recurrent"] = cell(step, rtrees, rspecs, 0)

    mcfg, mmodel, mparams, toks, s, cache, c_ps = moe_cell(moe_weights)
    mpps = param_pspecs(mcfg, fsdp_size=0, tp_size=4)
    tok_ps = batch_pspecs({"tokens": toks}, AXES)["tokens"]
    cells["moe_prefill"] = dryrun.Cell(
        lambda p, b: mmodel.prefill(p, b, max_len=s + 8),
        (on_meta(mparams), {"tokens": on_meta(toks[:, :s])}),
        (mpps, {"tokens": tok_ps}), None, (), None, None, 1)
    cells["moe_decode"] = dryrun.Cell(
        mmodel.decode_step,
        (on_meta(mparams), on_meta(cache), on_meta(toks[:, s:s + 1])),
        (mpps, c_ps, tok_ps), None, (1,), None, None, 1)

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        mesh = make_test_mesh((2, 4), AXES)
        got = {name: dryrun.partitioned_count(c, mesh).collectives
               for name, c in cells.items()}
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.core.profiler import count_step
        x = DTensor.from_local(torch.empty(2, 8, device="meta"), mesh,
                               [Replicate(), Shard(0)], run_check=False,
                               shape=torch.Size((8, 8)), stride=(8, 1))
        got["s2s"] = count_step(x.redistribute, mesh,
                                [Replicate(), Shard(1)]).collectives
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, "meta_counts.json"), "w") as f:
        json.dump(got, f)


def main():
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    if sys.argv[1] == "meta":
        meta_counts(*sys.argv[2:])
        return
    rank = int(sys.argv[1])
    store, out_dir, *weights = sys.argv[2:]
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        out, walls = run(rank, out_dir, *weights)
    finally:
        dist.destroy_process_group()
    walls["total"] = time.perf_counter() - t0
    out["walls"] = walls
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


main()
'''


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _reference_loss(jcfg, params, batch, accum: int = 1) -> float:
    """The reference's one-device train-step loss (``accum``
    microbatches)."""
    opt = jadamw(1e-3)
    step = jax.jit(jmake_train_step(JLM(jcfg), opt, accum_steps=accum))
    return float(step(params, opt.init(params),
                      {k: jnp.asarray(v) for k, v in batch.items()},
                      jnp.asarray(0, jnp.int32))[2]["loss"])


def _port_step(arch, dtype, params, batch, heads=None,
               accum: int = 1) -> dict:
    """The port's unmeshed train step of ``arch``'s smoke config at
    ``dtype`` activations (``heads`` query heads, where not None;
    ``accum`` microbatches) on the reference's weights: its loss,
    gradient norm and the gradients it hands the optimizer."""
    from repro_torch.optim.base import Optimizer
    tcfg = dataclasses.replace(tcfgs.get_smoke_config(arch), dtype=dtype)
    if heads is not None:
        tcfg = dataclasses.replace(tcfg, n_heads=heads)
    tparams_ = lm_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
    topt = adamw(1e-3)
    seen = {}

    def update(grads, state, p, step):
        seen["grads"] = grads
        return topt.update(grads, state, p, step)
    tbatch = {k: torch.from_numpy(v).to(torch.int64)
              for k, v in batch.items()}
    m = make_train_step(LM(tcfg), Optimizer(topt.init, update),
                        accum_steps=accum)(tparams_, topt.init(tparams_),
                                           tbatch, 0)[2]
    grads = {"/".join(path): t.numpy() for path, t in leaves(seen["grads"])}
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "grads": grads}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 8 ranks' results, the reference's one-device losses and the
    port's unmeshed steps, on the same weights and batches, and the meta
    pass's counts.  The ranks and the meta pass (a ninth process over a
    fake group) run side by side; the launch has CHILD_TIMEOUT seconds
    in all."""
    d = tmp_path_factory.mktemp("mesh")
    cfg = jcfgs.get_smoke_config("qwen2-72b")
    params = jinit(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (8, 17)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    np.savez(d / "weights.npz", **_flat(params),
             **{"__" + k: v for k, v in batch.items()})
    mcfg = dataclasses.replace(jcfgs.get_smoke_config("qwen2-moe-a2.7b"),
                               dtype="float32")
    mparams = jinit(mcfg, jax.random.PRNGKey(1))
    mtoks = rng.integers(0, mcfg.vocab_size, (32, 15)).astype(np.int32)
    np.savez(d / "moe.npz", **_flat(mparams), __tokens=mtoks)
    padded = {}
    for i, (arch, heads) in enumerate(PADDED.items()):
        pcfg = dataclasses.replace(jcfgs.get_smoke_config(arch),
                                   dtype="float32")
        if heads is not None:
            pcfg = dataclasses.replace(pcfg, n_heads=heads)
        pparams = jinit(pcfg, jax.random.PRNGKey(2 + i))
        ptoks = rng.integers(0, pcfg.vocab_size, (8, 17)).astype(np.int32)
        pbatch = {"tokens": ptoks[:, :-1], "labels": ptoks[:, 1:]}
        np.savez(d / f"padded_{arch}.npz", **_flat(pparams),
                 **{"__" + k: v for k, v in pbatch.items()})
        padded[arch] = (pcfg, pparams, pbatch)
    uneven = {}
    for arch, (ucfg, uparams) in zip(UNEVEN, ((cfg, params),
                                              (mcfg, mparams))):
        utoks = rng.integers(0, ucfg.vocab_size,
                             (UNEVEN_ROWS, 17)).astype(np.int32)
        ubatch = {"tokens": utoks[:, :-1], "labels": utoks[:, 1:]}
        np.savez(d / f"uneven_{arch}.npz", **_flat(uparams),
                 **{"__" + k: v for k, v in ubatch.items()})
        uneven[arch] = (dataclasses.replace(ucfg, dtype="float32"), uparams,
                        ubatch)
    script = d / "child.py"
    script.write_text(_CHILD)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               OMP_NUM_THREADS="1")
    npz = [str(d / f) for f in ("weights.npz", "moe.npz",
                                *(f"padded_{a}.npz" for a in PADDED),
                                *(f"uneven_{a}.npz" for a in UNEVEN))]
    argvs = [[str(r), str(d / "store"), str(d)] + npz for r in range(WORLD)]
    argvs.append(["meta", str(d)] + npz)
    procs, logs = [], []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)      # this process too, while the ranks run
    t0 = time.monotonic()
    try:
        for i, argv in enumerate(argvs):
            log = open(d / f"child{i}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, str(script), *argv],
                env=env, stdout=log, stderr=subprocess.STDOUT))
        # the one-device steps while the ranks run
        ref_loss = _reference_loss(cfg, params, batch)
        tcfg = tcfgs.get_smoke_config("qwen2-72b")
        topt = adamw(1e-3)
        tparams_ = lm_params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")
        tbatch = {k: torch.from_numpy(v).to(torch.int64)
                  for k, v in batch.items()}
        port = {"loss": float(make_train_step(LM(tcfg), topt)(
            tparams_, topt.init(tparams_), tbatch, 0)[2]["loss"])}
        f32 = _port_step("qwen2-72b", "float32", params, batch)
        port.update(loss_f32=f32["loss"], grad_norm_f32=f32["grad_norm"],
                    grads_f32=f32["grads"])
        for arch, (pcfg, pparams, pbatch) in padded.items():
            port["padded/" + arch] = _port_step(
                arch, "float32", pparams, pbatch, PADDED[arch])
            port["padded/" + arch]["ref_loss"] = _reference_loss(
                pcfg, pparams, pbatch)
        for arch, (ucfg, uparams, ubatch) in uneven.items():
            port["uneven/" + arch] = _port_step(
                arch, "float32", uparams, ubatch, accum=UNEVEN_ACCUM)
            port["uneven/" + arch]["ref_loss"] = _reference_loss(
                ucfg, uparams, ubatch, accum=UNEVEN_ACCUM)
        port["moe_reference"] = _reference_serving(mcfg, mparams, mtoks)
        codes = [p.wait(timeout=max(CHILD_TIMEOUT - (time.monotonic() - t0),
                                    1)) for p in procs]
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(codes):
        bad = codes.index(next(c for c in codes if c))
        raise AssertionError((codes, (d / f"child{bad}.log").read_text()
                              [-4000:]))
    outs = [json.loads((d / f"rank{r}.json").read_text())
            for r in range(WORLD)]
    with np.load(d / "meshed_grads.npz") as f:
        port["meshed_grads_f32"] = {k: f[k] for k in f.files}
    for arch in PADDED:
        with np.load(d / f"padded_grads_{arch}.npz") as f:
            port["padded/" + arch]["meshed_grads"] = {k: f[k]
                                                      for k in f.files}
    for arch in UNEVEN:
        with np.load(d / f"uneven_grads_{arch}.npz") as f:
            port["uneven/" + arch]["meshed_grads"] = {k: f[k]
                                                      for k in f.files}
    port["moe_meshed"] = np.load(d / "moe_logits.npy")
    port["meta_counts"] = json.loads((d / "meta_counts.json").read_text())
    return outs, ref_loss, port


def _reference_serving(cfg, params, toks, s=12):
    """The reference's prefill logits of ``toks[:, :s]`` and its decode
    logits for the rest, stacked."""
    model = JLM(cfg)
    cache, lg = jax.jit(lambda p, t: model.prefill(
        p, {"tokens": t}, max_len=s + 8))(params, jnp.asarray(toks[:, :s]))
    out = [np.asarray(lg, np.float32)]
    step = jax.jit(model.decode_step)
    for i in range(toks.shape[1] - s):
        lg, cache = step(params, cache, jnp.asarray(toks[:, s + i:s + i + 1]))
        out.append(np.asarray(lg, np.float32))
    return np.stack(out)


def test_mesh_names_are_current_inside_the_step(ranks):
    outs = ranks[0]
    for out in outs:
        assert out["axes_in_step"] == ["data", "model"]
        assert out["attention_on_shards"] > 0
        assert out["axes_after_leaving"] == []


def test_meshed_step_loss_matches_unmeshed_and_reference(ranks):
    outs, ref_loss, port = ranks
    port_loss = port["loss"]
    for out in outs:
        assert np.isfinite(out["loss_meshed"])
        assert out["loss_meshed"] == outs[0]["loss_meshed"]
        assert abs(out["loss_meshed"] - port_loss) < 5e-2, (out, port_loss)
        assert abs(out["loss_meshed"] - ref_loss) < 5e-2, (out, ref_loss)
    assert abs(port_loss - ref_loss) < 5e-2, (port_loss, ref_loss)


def test_meshed_step_gradients_and_update_match_unmeshed(ranks):
    """What the meshed step does in backward and in the update: its loss
    and gradient norm and every gradient, gathered whole (the data axes'
    partial sums reduced, the replicated KV heads' partial sums), against
    the port's unmeshed step on the same weights and batch, both with
    float32 activations, where the mesh only reorders sums (in bfloat16
    that alone moves single gradients by a few %); and AdamW's update on
    the DTensors against the same update on the gathered trees."""
    outs, _, port = ranks
    for out in outs:
        assert out["loss_meshed_f32"] == pytest.approx(port["loss_f32"],
                                                       rel=1e-6)
        assert out["grad_norm_meshed_f32"] == pytest.approx(
            port["grad_norm_f32"], rel=1e-5)
        # a few float32 ulps of each leaf's largest parameter
        assert out["update_err"] <= 1e-6, out["update_err"]
    got, want = port["meshed_grads_f32"], port["grads_f32"]
    assert sorted(got) == sorted(want)
    for k in want:       # 1e-5 of the leaf's largest gradient
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_params_and_opt_state_keep_placements(ranks):
    outs = ranks[0]
    for out in outs:
        assert out["params_keep_placements"]
        assert out["opt_keeps_placements"]
        assert out["sharded_leaves"] > 0


def test_restore_latest_with_shardings(ranks):
    outs = ranks[0]
    for out in outs:
        assert out["ckpt_step"] == 3
        assert out["ckpt_placements"]
        assert out["ckpt_local_equal"] and out["ckpt_whole_equal"]


def test_make_batch_sharding_gives_reference_axes(ranks):
    """The reference shards the batch dim over ``("data",)`` on a
    ``(data, model)`` mesh."""
    outs = ranks[0]
    for out in outs:
        assert out["batch_sharding_axes"] == ["data"] == out["batch_axes"]


def test_constrain_and_logical_to_mesh_on_a_mesh(ranks):
    outs = ranks[0]
    for out in outs:
        assert out["logical_to_mesh"] == [["data"], "model", None, None]
        assert out["constrain_placements"] == ["S(0)", "S(1)"]
        assert out["constrain_equal"]


def test_flash_attention_on_dtensors_equals_whole(ranks):
    outs = ranks[0]
    for out in outs:
        assert len(out["attention_cases"]) == 5
        for case in out["attention_cases"]:
            assert case["err"] <= 1e-5, case      # atol 1e-5, rtol 1e-5


def test_meshed_step_collective_bytes_equal_the_meta_pass(ranks):
    """Rank 0's count of the meshed training step on real tensors: its
    collective bytes by kind equal the dry run's partitioned pass of the
    same step and layouts on meta shards over a fake group of 8 ranks,
    exactly; every rank moves the same bytes."""
    outs, _, port = ranks
    got = outs[0]["step_collectives"]
    assert got and sum(got.values()) > 0
    assert got == port["meta_counts"]["train"]
    for out in outs:
        assert out["step_collectives"] == got


@pytest.mark.parametrize("step", ["moe_prefill", "moe_decode", "recurrent"])
def test_meshed_serving_and_recurrent_collectives_equal_the_meta_pass(
        ranks, step):
    """Rank 0's counts on real tensors of qwen2-moe-a2.7b's meshed
    prefill, of its decode step from a cache laid out by
    ``cache_pspecs``, and of xlstm-125m's training step (time loops
    walked): their collective bytes by kind equal the dry run's
    partitioned pass of the same cells on meta shards over a fake group
    of 8 ranks, exactly (the xLSTM loops run one step under ``repeated``
    there)."""
    outs, _, port = ranks
    got = outs[0][f"{step}_collectives"]
    assert got and sum(got.values()) > 0
    assert got == port["meta_counts"][step]


def test_meshed_moe_serving_matches_unmeshed_and_reference(ranks):
    """qwen2-moe-a2.7b's smoke model at float32: a prefill and 3 decode
    steps with params, tokens and cache as DTensors on the (2, 4) mesh
    against the same run unmeshed (1e-5 of the largest logit) and the
    reference's (5e-2)."""
    outs, _, port = ranks
    for out in outs:
        assert out["moe_logits_err"] <= 1e-5, out["moe_logits_err"]
        assert out["moe_cache_err"] <= 1e-5, out["moe_cache_err"]
        assert out["moe_cache_dtensors"] > 0
        assert out["moe_logits_placements"] == ["S(0)", "R"]
    got, want = port["moe_meshed"], port["moe_reference"]
    assert got.shape == want.shape == (4, 32, want.shape[-1])
    assert np.abs(got - want).max() <= 5e-2, np.abs(got - want).max()


@pytest.mark.parametrize("arch", list(PADDED))
def test_meshed_padded_head_step_matches_unmeshed_and_reference(ranks,
                                                                arch):
    """At float32 on the (2, 4) mesh, where ``model`` 4 does not divide
    the query heads, they run padded (``sharding.split_heads``):
    qwen2.5-32b's smoke config (5 query heads, 1 KV head) padded to 8,
    two a device; deepseek-v3-671b's with 3 MLA heads (each with its own
    K and V: q, k and v padded alike) to 4, one a device.  Its loss
    within rel 1e-6 of the port's unmeshed step, its gradient norm within
    rel 1e-5 and every gradient within 1e-5 of its leaf's largest (the
    bounds of the qwen2-72b case); its loss within 5e-2 of the
    reference's one-device step; rank 0's collectives by kind equal to
    the meta pass's, exactly (a device whose heads are pads receives
    less in the all-to-alls)."""
    outs, _, port = ranks
    want = port["padded/" + arch]
    for out in outs:
        got = out["padded/" + arch]
        assert got["pad_calls"] > 0
        assert got["loss_f32"] == pytest.approx(want["loss"], rel=1e-6)
        assert got["grad_norm_f32"] == pytest.approx(want["grad_norm"],
                                                     rel=1e-5)
        assert abs(got["loss_f32"] - want["ref_loss"]) < 5e-2
    got = want["meshed_grads"]
    assert sorted(got) == sorted(want["grads"])
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    coll = outs[0]["padded/" + arch]["collectives"]
    assert coll.get("all-to-all", 0) > 0
    assert coll == port["meta_counts"]["padded/" + arch]


def test_vocab_parallel_ce_chunk_matches_unmeshed(ranks):
    """One cross-entropy chunk at float32 on logits whose vocab the mesh
    splits over ``model`` (padded columns masked, ignored labels): the
    log-sum-exp runs on each device's shard with two all-reduces and no
    gather; its loss within rel 1e-6 of the unmeshed chunk's and its
    gradients within 1e-5 of each one's largest (the meshed step's
    bounds).  The meshed step takes the same path."""
    outs = ranks[0]
    for out in outs:
        assert out["ce_vocab_parallel_calls"] == 1
        assert out["vocab_parallel_lse_in_step"] > 0
        got, want = out["ce_loss"]
        assert got == pytest.approx(want, rel=1e-6)
        assert out["ce_count"][0] == out["ce_count"][1] == 22
        assert out["ce_grad_err"] <= 1e-5, out["ce_grad_err"]
        coll = out["ce_collectives"]
        assert coll.get("all-gather", 0) == 0, coll
        # the row max and the row sum: 2 x (2 rows x 6 positions) x 4 B
        # over ``model``, beside the label pick's partial sum
        assert coll.get("all-reduce", 0) >= 2 * 2 * 6 * 4, coll


@pytest.mark.parametrize("arch", UNEVEN)
def test_meshed_uneven_microbatch_step_matches_unmeshed_and_reference(
        ranks, arch):
    """At float32 on the (2, 4) mesh, 6 rows in 2 microbatches of 3, which
    ``data`` 2 does not divide: each microbatch runs padded to 4 rows,
    two a device (``sharding.split_rows``), as XLA pads the reference's;
    a dense (qwen2-72b) and a MoE (qwen2-moe-a2.7b, whose load-balance
    loss takes its means over the real rows) smoke model.  Its loss
    within rel 1e-6 of the port's unmeshed step (which runs the 3 rows),
    its gradient norm within rel 1e-5 and every gradient it hands the
    optimizer within 1e-5 of its leaf's largest; its loss within 5e-2 of
    the reference's one-device step of 2 microbatches; rank 0's
    collectives by kind equal to the meta pass's, exactly, the batch
    re-laid out by all-to-alls."""
    outs, _, port = ranks
    want = port["uneven/" + arch]
    for out in outs:
        got = out["uneven/" + arch]
        assert got["rows"] == [[2, 16], [2, 16]]
        assert got["loss_f32"] == pytest.approx(want["loss"], rel=1e-6)
        assert got["grad_norm_f32"] == pytest.approx(want["grad_norm"],
                                                     rel=1e-5)
        assert abs(got["loss_f32"] - want["ref_loss"]) < 5e-2
    got = want["meshed_grads"]
    assert sorted(got) == sorted(want["grads"])
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    coll = outs[0]["uneven/" + arch]["collectives"]
    assert coll.get("all-to-all", 0) > 0
    assert coll == port["meta_counts"]["uneven/" + arch]


def test_shard_to_shard_counts_one_all_to_all(ranks):
    """A Shard-to-Shard redistribute over ``model`` (an (8, 8) float32
    tensor's rows split 4 ways, to its columns): on gloo DTensor takes
    an all-gather and a chunk, the count one all-to-all of the 2 x 8
    shard, 64 B, and no all-gather, as the meta pass over a fake group
    counts it and as NCCL would send it; the values are the tensor's."""
    outs, _, port = ranks
    for out in outs:
        assert out["s2s_collectives"] == {"all-to-all": 2 * 8 * 4.0}
        assert out["s2s_placements"] == ["R", "S(1)"]
        assert out["s2s_equal"]
    assert port["meta_counts"]["s2s"] == {"all-to-all": 2 * 8 * 4.0}


def test_microbatch_rows_over_pods_run_padded(ranks):
    """A batch whose rows (pod, data) split together, on a (2, 2, 2)
    mesh: 12 rows in 2 microbatches of 6 and in 4 of 3, each padded to a
    multiple of the 4 data devices (8 and 4 rows, 2 and 1 a device), its
    rows those of the batch in order and its pads -1 at the end, on
    every rank."""
    x = np.arange(36).reshape(12, 3)
    for out in ranks[0]:
        for accum, q in (("2", 2), ("4", 1)):
            mbs = out["rows_over_pods"][accum]
            r = 12 // int(accum)
            assert len(mbs) == int(accum)
            for i, (local, whole) in enumerate(mbs):
                want = np.full((4 * q, 3), -1)
                want[:r] = x[i * r:(i + 1) * r]
                assert local == [q, 3]
                assert np.array_equal(np.array(whole), want)
