"""Shape-only dry run of every (arch x shape x mesh) cell, on ``meta``.

The twin of ``repro.launch.dryrun``.  The reference lowers and compiles
each cell's step for 512 fake XLA devices, SPMD-partitioned, and reads
XLA's memory and cost analyses and the partitioned HLO's collectives.
The port compiles nothing.  It builds the same step (train / prefill /
decode) at the config's full size and counts it twice, under
``core.profiler``'s counting mode:

* globally: once on plain ``meta`` tensors (``flops_by_category`` and
  ``traffic_bytes`` of the whole step, every device), as the reference's
  jaxpr walker gives them;
* per device (the partitioned pass): again on DTensor trees laid out by
  the partition-spec trees (``param_pspecs``, ``opt_pspecs``,
  ``batch_pspecs``, ``cache_pspecs``) on the production mesh, each leaf
  holding the first device's shard on ``meta``
  (``distributed.sharding.meta_tree``).  DTensor runs each op as that
  device's local ops and the collectives its layouts need; the count
  gives the device's FLOPs (``flops``), bytes (``bytes_accessed``) and
  collective bytes by kind (``collective_bytes``, each collective counted
  as max(result, operand), the reference's rule).  Every loop trip is
  counted (a Python loop runs trip by trip; the xLSTM time loops run one
  step under ``core.profiler.repeated``, which multiplies its collectives
  too), where XLA's cost analysis counts a loop body once: so
  ``scan_correction`` is 1.0 and each ``*_corrected`` key equals its raw
  key.  These bytes are the eager step's own traffic (every op's operands
  and results); ``bytes_min`` is what a device's step must move at least
  (``step_bytes_min``), the memory term of the roofline's bound.

On 2x16x16 the step is modelled, not partitioned whole: one pod's step on
its 16x16 slice at the pod's half of the batch, plus the gradients'
reduction across the pods (``"partition": "pod_slice+cross_pod_reduce"``;
16x16 records say ``"mesh"``), in all its configured microbatches
(``accum_counted`` == ``accum_steps``): a microbatch whose rows the data
devices do not divide runs padded (``sharding.split_rows``), as XLA pads
the reference's (nemotron-4-340b's ``--opt`` step: 16 microbatches of 8
rows on a pod's 16 data devices, each padded to 16).

The production meshes are built over torch's fake process group (512
ranks, no devices); its collectives return shapes only.  The meshes'
device type is ``cpu``, so a Shard-to-Shard redistribute takes DTensor's
CPU route, an all-gather and a local chunk, where NCCL sends an
all-to-all: the count takes it as the all-to-all the card sends
(``core.profiler``; a record's ``shard_to_shard`` tallies them).  The
per-device bytes of the arguments and outputs also come from the spec
trees.  Keys that only an XLA compile gives stay None:
``temp_bytes_per_device`` (and so ``peak_bytes_per_device``),
``lower_s`` and ``compile_s``; ``"source": "meta"`` says so.  Beside the
reference's ``fits_16gb`` the analytic memory model has
``fits_h100_80gb``.

Artifacts land in ``build/dryrun/<arch>__<shape>__<mesh>.json`` (``--outdir``
overrides it; ``--opt`` defaults to ``build/dryrun_opt/``).  It runs in its
own process:

  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k --mesh both
  python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--opt]
  python -m repro_torch.launch.dryrun --cell stablelm-1.6b train_4k both \
      --cell qwen2-moe-a2.7b decode_32k single
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist

from repro_torch import configs as cfgs
from repro_torch.core.profiler import Counts, count_step
from repro_torch.distributed.compat import enter_mesh
from repro_torch.distributed.sharding import (gather_fsdp, meta_tree,
                                              mesh_ops)
from repro_torch.distributed.specs import (batch_pspecs, cache_pspecs,
                                           opt_pspecs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model import LM
from repro_torch.models.params import (leaves, param_counts, param_pspecs,
                                       param_shape_structs)
from repro_torch.optim import adafactor, adamw
from repro_torch.train.steps import make_train_step

__all__ = ["ACCUM", "ADAFACTOR_ARCHS", "OPT_SETTINGS", "apply_opt",
           "analytic_memory", "mesh_dims", "build_cell", "count_on_mesh",
           "partitioned_count", "ce_chunk_count", "device_counts",
           "carry_bytes", "step_bytes_min",
           "run_cell", "all_cells", "main"]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")

# microbatch accumulation per (arch family size): bounds activation peak
ACCUM = {"nemotron-4-340b": 8, "deepseek-v3-671b": 8, "qwen2-72b": 4,
         "qwen2.5-32b": 4, "llava-next-34b": 4, "recurrentgemma-9b": 2}

# >=30B params: Adafactor (factored 2nd moment); else AdamW
ADAFACTOR_ARCHS = {"qwen2-72b", "qwen2.5-32b", "nemotron-4-340b",
                   "llava-next-34b", "deepseek-v3-671b"}

# the reference's per-arch settings (``--opt``): act: residual-stream
# sharding mode; group: 2-level remat group size; accum: microbatch count
# override; moe_cf: MoE capacity factor override
OPT_SETTINGS = {
    "qwen2-72b": {"act": "sp"},
    "deepseek-v3-671b": {"moe_cf": 1.0},
    "nemotron-4-340b": {"group": 8, "accum": 16},
}

# an H100's device memory: 80 GB
H100_HBM_BYTES = 80e9
# ranks of the fake process group the production meshes are built over
_FAKE_WORLD = 512


def apply_opt(arch: str) -> None:
    o = OPT_SETTINGS.get(arch, {})
    os.environ["REPRO_ACT_SHARDING"] = o.get("act", "baseline")
    os.environ["REPRO_REMAT_GROUP"] = str(o.get("group", 1))
    if "accum" in o:
        ACCUM[arch] = o["accum"]
    if "moe_cf" in o:
        # the override is read by build_cell from the environment
        os.environ["REPRO_MOE_CF"] = str(o["moe_cf"])
    else:
        os.environ.pop("REPRO_MOE_CF", None)


@dataclasses.dataclass(frozen=True)
class MeshDims:
    """A mesh's dim sizes by name and its device count: all that the
    memory model reads of a mesh."""
    shape: dict[str, int]
    size: int


def mesh_dims(mesh) -> MeshDims:
    """``mesh`` (a ``DeviceMesh``, or already ``MeshDims``) as
    ``MeshDims``."""
    if isinstance(mesh, MeshDims):
        return mesh
    names = tuple(mesh.mesh_dim_names)
    return MeshDims({n: mesh.size(i) for i, n in enumerate(names)},
                    mesh.size())


def _tree_bytes(tree: Any) -> int:
    return sum(math.prod(t.shape) * t.element_size()
               for _, t in leaves(tree))


def analytic_memory(cfg, sh, mesh: MeshDims, accum, p_sds, opt_sds,
                    cache_sds) -> dict:
    """Per-device residency model, the reference's arithmetic in its
    order.

    params/opt: template bytes / (tp x fsdp);  grads: one more param copy;
    activations: saved carries (n_layers x microbatch x S x d) x1.5 for
    per-block extras;  cache: sharded decode cache.
    """
    tp = mesh.shape["model"]
    dp = mesh.size // tp
    fsdp = mesh.shape["data"] if cfg.param_dtype == "bfloat16" else 1
    shard = tp * fsdp
    out = {"params": _tree_bytes(p_sds) / shard}
    out["opt"] = _tree_bytes(opt_sds) / shard if opt_sds is not None else 0.0
    out["grads"] = out["params"]
    if sh.kind == "train":
        mb = max(sh.global_batch // (dp * accum), 1)
        act = 2  # bf16 activations
        layers = cfg.n_layers + cfg.encoder_layers
        out["activations"] = 1.5 * layers * mb * sh.seq_len * cfg.d_model * act
    else:
        out["grads"] = 0.0
        mb = max(sh.global_batch // dp, 1)
        out["activations"] = 3 * mb * sh.seq_len * cfg.d_model * 2 \
            if sh.kind == "prefill" else 0.0
    out["cache"] = (_tree_bytes(cache_sds) / mesh.size
                    if cache_sds is not None else 0.0)
    out["total"] = sum(out.values())
    out = {k: float(v) for k, v in out.items()}
    out["fits_16gb"] = bool(out["total"] < 16 * 2 ** 30)
    out["fits_h100_80gb"] = bool(out["total"] < H100_HBM_BYTES)
    return out


def _local_bytes(tree: Any, specs: Any, dims: MeshDims) -> int:
    """Bytes of one device's shards of ``tree`` laid out by ``specs``
    (None: replicated): each sharded dim split by ceiling over each mesh
    axis its entry names, in order, as DTensor's ``Shard`` splits it (the
    first device's shard, the largest)."""
    spec_of = dict(leaves(specs)) if specs is not None else {}
    total = 0
    for path, t in leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        shape = list(t.shape)
        for d, entry in enumerate(spec_of.get(path) or ()):
            for name in ((entry,) if isinstance(entry, str)
                         else entry or ()):
                if name in dims.shape:
                    shape[d] = -(-shape[d] // dims.shape[name])
        total += math.prod(shape) * t.element_size()
    return total


@dataclasses.dataclass
class Cell:
    """One cell's step on ``meta``: ``fn(*args)``, the specs of its
    tensor arguments and outputs (None: replicated), and the argument
    indices it donates."""
    fn: Any
    args: tuple
    in_specs: tuple
    out_specs: Any    # fn's output -> its spec trees (None: replicated)
    donate: tuple
    opt_sds: Any
    cache_sds: Any
    accum: int


def build_cell(arch: str, shape_name, mesh, *, cfg=None,
               pods: int = 1) -> Cell:
    """The cell's step at ``arch``'s full-size config (or ``cfg``), for
    ``shape_name`` (a name of ``SHAPES`` or a ``Shape``) on ``mesh`` (a
    ``DeviceMesh`` or ``MeshDims``).  With ``pods`` > 1, one pod's step:
    the batch split over the pods where it divides, laid out as the whole
    mesh lays it out, in all its microbatches (rows that the data devices
    do not divide run padded)."""
    cfg = cfg or cfgs.get_config(arch)
    if os.environ.get("REPRO_MOE_CF") and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(os.environ["REPRO_MOE_CF"])))
    sh = (shape_name if isinstance(shape_name, cfgs.Shape)
          else cfgs.SHAPES[shape_name])
    spec_batch, dp_total = sh.global_batch, 32
    if pods > 1 and sh.global_batch % pods == 0:
        sh = dataclasses.replace(sh, global_batch=sh.global_batch // pods)
        dp_total //= pods
    model = LM(cfg)
    dims = mesh_dims(mesh)
    tp = dims.shape["model"]
    fsdp = dims.shape["data"] if cfg.param_dtype == "bfloat16" else 0
    p_ps = param_pspecs(cfg, fsdp_size=fsdp, tp_size=tp)
    p_sds = param_shape_structs(cfg)
    mesh_axes = tuple(dims.shape)

    if sh.kind == "train":
        opt = adafactor(1e-4) if arch in ADAFACTOR_ARCHS else adamw(1e-4)
        accum = ACCUM.get(arch, 1)
        step_fn = make_train_step(model, opt, accum_steps=accum)
        batch_sds = cfgs.input_specs(cfg, sh)
        opt_sds = opt.init(p_sds)
        o_ps = opt_pspecs(opt_sds, p_ps)
        b_ps = batch_pspecs(batch_sds, mesh_axes, dp_total)
        return Cell(step_fn, (p_sds, opt_sds, batch_sds, 0),
                    (p_ps, o_ps, b_ps, None),
                    lambda out: (p_ps, o_ps, None), (0, 1), opt_sds, None,
                    accum)

    if sh.kind == "prefill":
        batch_sds = cfgs.input_specs(cfg, sh)
        b_ps = batch_pspecs(batch_sds, mesh_axes, dp_total)

        def prefill_fn(params, batch):
            with torch.no_grad():
                return model.prefill(params, batch, max_len=sh.seq_len + 128)

        def out_specs(out):
            return (cache_pspecs(cfg, out[0], mesh_axes, tp, spec_batch),
                    None)
        return Cell(prefill_fn, (p_sds, batch_sds), (p_ps, b_ps), out_specs,
                    (), None, None, 1)

    # decode: one token against a seq_len cache
    cache_sds = model.init_cache(sh.global_batch, sh.seq_len, device="meta")
    if cfg.is_encdec:  # decode against encoder memory
        cache_sds = dict(cache_sds, enc_out=torch.empty(
            (sh.global_batch, 4096, cfg.d_model), dtype=cfg.activation_dtype,
            device="meta"))
    c_ps = cache_pspecs(cfg, cache_sds, mesh_axes, tp, spec_batch)
    tok_sds = cfgs.input_specs(cfg, sh)["tokens"]
    b_ps = batch_pspecs({"tokens": tok_sds}, mesh_axes, dp_total)["tokens"]

    def decode_fn(params, cache, tokens):
        with torch.no_grad():
            return model.decode_step(params, cache, tokens)

    return Cell(decode_fn, (p_sds, cache_sds, tok_sds), (p_ps, c_ps, b_ps),
                lambda out: (None, c_ps), (1,), None, cache_sds, 1)


def _arg_bytes(trees, specs, dims: MeshDims) -> list[int]:
    """Per-device bytes of each of ``trees`` (a tensor or a dict of them)
    laid out by its entry of ``specs``; what is not a tensor (the step
    number, a host float) counts nothing."""
    return [_local_bytes({"x": tree}, None if spec is None else {"x": spec},
                         dims) for tree, spec in zip(trees, specs)]


def count_on_mesh(mesh, fn, *args) -> Counts:
    """``fn(*args)`` counted under ``core.profiler``'s counting mode with
    ``mesh`` (a ``DeviceMesh``) current, under ``sharding.mesh_ops``."""
    enter_mesh(mesh)
    try:
        with mesh_ops():
            return count_step(fn, *args)
    finally:
        enter_mesh(None)


def partitioned_count(cell: Cell, mesh) -> Counts:
    """One device's share of ``cell``'s step on ``mesh``: the step run on
    its arguments laid out by ``cell.in_specs`` as DTensors holding the
    first device's shards on ``meta``, counted."""
    return count_on_mesh(mesh, cell.fn, *(
        meta_tree(a, spec, mesh)
        for a, spec in zip(cell.args, cell.in_specs)))


def ce_chunk_count(cell: Cell, cfg, mesh) -> Counts:
    """One device's count of one cross-entropy chunk's forward
    (``models.layers._ce_chunk``) in ``cell``'s train step on ``mesh``:
    the final hidden state's chunk (B, S / logit_chunks, D) batch-sharded
    over the data axes as the step's input is, the head laid out by its
    parameter spec with its FSDP split gathered (as ``LM.loss`` gathers it
    before the chunks, uncounted here), the labels by the batch spec.
    Where the mesh splits the vocab, the log-sum-exp runs on each
    device's shard (``models.layers._VocabParallelLSE``): two all-reduces
    of one value a row (its max and its sum), and no gather."""
    from repro_torch.models.layers import _ce_chunk
    params, batch = cell.args[0], cell.args[2]
    p_ps, b_ps = cell.in_specs[0], cell.in_specs[2]
    name = "embed" if cfg.tie_embeddings else "head"
    b, s = batch["labels"].shape
    chunks = cfg.logit_chunks if s % cfg.logit_chunks == 0 else 1
    x = torch.empty((b, s // chunks, cfg.d_model),
                    dtype=cfg.activation_dtype, device="meta")
    lab = torch.empty((b, s // chunks), dtype=torch.int64, device="meta")
    xd, ld = (meta_tree(t, b_ps["labels"][:1] + (None,) * (t.ndim - 1), mesh)
              for t in (x, lab))
    head = gather_fsdp(meta_tree(params[name], p_ps[name], mesh))
    return count_on_mesh(mesh, lambda: _ce_chunk(
        xd, ld, head.to(cfg.activation_dtype), cfg.vocab_size))


def _cross_pod_reduce(cell: Cell, mesh) -> dict[str, float]:
    """Collective bytes by kind of one device's share of the gradients'
    reduction across the pods of ``mesh`` (a ``(pod, data, model)``
    ``DeviceMesh``), once a microbatch as the train step reduces them:
    each gradient shard, a partial sum over ``pod``, redistributed to its
    parameter's placements, on ``meta``."""
    from torch.distributed.tensor import DTensor, Partial
    from repro_torch.distributed.sharding import local_shape, placements
    pod = list(mesh.mesh_dim_names).index("pod")
    spec_of = dict(leaves(cell.in_specs[0]))

    def reduce_all():
        for path, t in leaves(cell.args[0]):
            pl = placements(spec_of[path], mesh)
            part = list(pl)
            part[pod] = Partial()
            g = DTensor.from_local(
                torch.empty(local_shape(t.shape, pl, mesh), dtype=t.dtype,
                            device="meta"),
                mesh, part, run_check=False, shape=t.shape, stride=t.stride())
            g.redistribute(mesh, pl)

    got = count_step(reduce_all).collectives
    return {k: v * cell.accum for k, v in got.items()}


def device_counts(arch: str, shape_name, mesh, *, cfg=None
                  ) -> tuple[Counts, dict[str, float] | None, int]:
    """One device's counts of the cell's step on ``mesh`` (a
    ``DeviceMesh``), a train cell's collective bytes by kind of one
    cross-entropy chunk (``ce_chunk_count``; None for the other kinds),
    and the microbatches counted.  On a mesh with a ``pod`` dim: one
    pod's step on its ``(data, model)`` slice, plus the gradients'
    reduction across the pods, the only work the pod axis carries
    (``launch.mesh``)."""
    sh = (shape_name if isinstance(shape_name, cfgs.Shape)
          else cfgs.SHAPES[shape_name])
    dims = mesh_dims(mesh)
    if "pod" in dims.shape:
        cell = build_cell(arch, sh, dims, cfg=cfg, pods=dims.shape["pod"])
        sub = mesh["data", "model"]
        part = partitioned_count(cell, sub)
        if sh.kind == "train":
            for k, v in _cross_pod_reduce(cell, mesh).items():
                part.collectives[k] = part.collectives.get(k, 0.0) + v
    else:
        cell = build_cell(arch, sh, dims, cfg=cfg)
        sub = mesh
        part = partitioned_count(cell, mesh)
    ce = None
    if sh.kind == "train":
        ce = {k: float(v) for k, v in sorted(ce_chunk_count(
            cell, cfg or cfgs.get_config(arch), sub).collectives.items())}
    return part, ce, cell.accum


def carry_bytes(cfg, sh, dims: MeshDims) -> float:
    """Bytes a device's train step saves at the block boundaries over
    all its microbatches: the residual stream (batch x sequence x
    d_model, in the activation dtype) at the input of each block of the
    decoder stack, the device's rows of the batch split over the data
    axes (and its share of the model axis where the 'sp' mode splits the
    stream).  A remat group or none keeps at least these; an encoder's or
    a vision prefix's blocks are left out."""
    from repro_torch.distributed.sharding import activation_sharding_mode
    tp = dims.shape["model"]
    split = (dims.size // tp) * (tp if activation_sharding_mode() == "sp"
                                 else 1)
    return (cfg.n_layers * sh.global_batch * sh.seq_len * cfg.d_model
            * torch.empty((), dtype=cfg.activation_dtype).element_size()
            / split)


def step_bytes_min(kind: str, arg_bytes: float, output_bytes: float,
                   alias_bytes: float, grad_bytes: float = 0.0,
                   carries: float = 0.0) -> float:
    """The bytes one device's step must move at least: the memory term of
    its roofline bound.  Every argument is read once and every output
    written once, but an output that aliases a donated argument only
    where the step changes it: a decode step writes one position of its
    cache, left out here, while a train step rewrites its parameters and
    optimizer state whole.  A train step also writes its gradients
    (``grad_bytes``) and reads them back once (the optimizer steps after
    the whole backward: clipping needs their global norm), and writes
    ``carries`` (``carry_bytes``) in its forward and reads them back in
    its backward.  Nothing else counts: every elementwise pass and every
    attention tile fused, no weight read twice, no activation stored but
    the carries, every expert of a MoE read (at the production decode
    batch, batch x top-k is at least the expert count; a routing that
    leaves an expert idle moves less)."""
    total = arg_bytes + output_bytes
    if kind == "train":
        return total + 2 * (grad_bytes + carries)
    if kind == "decode":
        return total - alias_bytes
    return total


def _ensure_world() -> None:
    """The fake process group the production meshes are built over."""
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=_FAKE_WORLD)


# (arch, shape, the --opt environment) -> (flops, bytes, output, seconds):
# the counts are global, the same on both meshes
_COUNTS: dict[tuple, tuple] = {}


def _env_key() -> tuple:
    return tuple(os.environ.get(k) for k in (
        "REPRO_ACT_SHARDING", "REPRO_REMAT_GROUP", "REPRO_MOE_CF",
        "REPRO_REMAT_POLICY"))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, art_dir: str | None = None) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    cell_id = f"{arch}__{shape_name}__{mesh_name}"
    _ensure_world()
    mesh = make_production_mesh(multi_pod=multi_pod)
    dims = mesh_dims(mesh)
    cell = build_cell(arch, shape_name, mesh)
    enter_mesh(mesh)   # the model's constraints see the mesh's names
    try:
        key = (arch, shape_name, ACCUM.get(arch, 1)) + _env_key()
        if key not in _COUNTS:
            t0 = time.time()
            c = count_step(cell.fn, *cell.args)
            _COUNTS[key] = (c.flops, c.bytes, c.out, time.time() - t0)
        cats, nbytes, out, t_count = _COUNTS[key]
    finally:
        enter_mesh(None)
    t0 = time.time()
    part, ce, accum_counted = device_counts(arch, shape_name, mesh)
    t_part = time.time() - t0
    if cfgs.SHAPES[shape_name].kind == "prefill":
        cell.cache_sds = out[0]       # the cache the prefill built
    args_b = _arg_bytes(cell.args, cell.in_specs, dims)
    out_b = _arg_bytes(out, cell.out_specs(out), dims)
    alias = sum(args_b[i] for i in cell.donate)
    flops = sum(v for k, v in cats.items() if not k.startswith("__"))
    dev_flops = sum(v for k, v in part.flops.items()
                    if not k.startswith("__"))
    coll = {k: float(v) for k, v in sorted(part.collectives.items())}
    coll_total = float(sum(coll.values()))

    cfg = cfgs.get_config(arch)
    sh = cfgs.SHAPES[shape_name]
    total_p, active_p = param_counts(cfg)
    analytic = analytic_memory(cfg, sh, dims,
                               cell.accum, cell.args[0], cell.opt_sds,
                               cell.cache_sds)
    record = {
        "cell": cell_id, "arch": arch, "shape": shape_name,
        "mesh": mesh_name, "devices": int(dims.size), "source": "meta",
        "kind": sh.kind, "global_batch": sh.global_batch,
        "seq_len": sh.seq_len,
        "flops": float(dev_flops),
        "flops_by_category_per_device": {k: float(v)
                                         for k, v in part.flops.items()},
        "jaxpr_flops_global": float(flops),
        "jaxpr_flops_by_category": {k: float(v) for k, v in cats.items()},
        "scan_correction": 1.0,
        "bytes_accessed": float(part.bytes),
        "bytes_accessed_corrected": float(part.bytes),
        "bytes_min": float(step_bytes_min(
            sh.kind, sum(args_b), sum(out_b), alias, args_b[0],
            carry_bytes(cfg, sh, dims) if sh.kind == "train" else 0.0)),
        "jaxpr_traffic_bytes_global": float(nbytes),
        "collective_bytes": coll,
        "collective_bytes_total": coll_total,
        "collective_bytes_corrected": coll_total,
        "ce_chunk_collective_bytes": ce,
        "shard_to_shard": part.shard_to_shard,
        "argument_bytes_per_device": int(sum(args_b)),
        "output_bytes_per_device": int(sum(out_b)),
        "temp_bytes_per_device": None,
        "alias_bytes_per_device": int(alias),
        "peak_bytes_per_device": None,
        "analytic_memory_per_device": analytic,
        "params_total": total_p, "params_active": active_p,
        "accum_steps": cell.accum, "accum_counted": accum_counted,
        "partition": ("pod_slice+cross_pod_reduce" if "pod" in dims.shape
                      else "mesh"),
        "lower_s": None, "compile_s": None, "count_s": round(t_count, 2),
        "partition_s": round(t_part, 2),
    }
    print(f"[dryrun] {cell_id}: flops(global)={flops:.3e} "
          f"bytes(global)={nbytes:.3e} flops/dev={dev_flops:.3e} "
          f"bytes/dev={part.bytes:.3e} coll/dev={coll_total:.3e} "
          f"args/dev={record['argument_bytes_per_device'] / 2**30:.2f}GiB "
          f"analytic/dev={analytic['total'] / 2**30:.2f}GiB "
          f"(count {t_count:.1f}s, partitioned {t_part:.1f}s)", flush=True)
    if save:
        d = art_dir or ARTIFACT_DIR
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, cell_id + ".json"), "w") as f:
            json.dump(record, f, indent=1)
    return record


def all_cells() -> list[tuple[str, str]]:
    out = []
    for arch in cfgs.ARCHS:
        fam = cfgs.get_config(arch).family
        for shape_name in cfgs.applicable_shapes(fam):
            out.append((arch, shape_name))
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cell", nargs=3, action="append", default=[],
                    metavar=("ARCH", "SHAPE", "MESH"),
                    help="one cell on one mesh (single, multi or both); "
                         "repeatable")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="the per-arch settings of OPT_SETTINGS")
    ap.add_argument("--outdir", default=None)
    args = ap.parse_args(argv)
    if args.opt and args.outdir is None:
        args.outdir = os.path.join(os.path.dirname(ARTIFACT_DIR),
                                   "dryrun_opt")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}
    if args.cell:
        jobs = [(arch, shape, multi) for arch, shape, mesh in args.cell
                for multi in meshes[mesh]]
    else:
        cells = all_cells() if args.all else [(args.arch, args.shape)]
        jobs = [(arch, shape, multi) for arch, shape in cells
                for multi in meshes[args.mesh]]
    failures = []
    try:
        for arch, shape_name, multi in jobs:
            cell_id = (f"{arch}__{shape_name}__"
                       f"{'multi' if multi else 'single'}")
            path = os.path.join(args.outdir or ARTIFACT_DIR,
                                cell_id + ".json")
            if args.skip_existing and os.path.exists(path):
                print(f"[dryrun] {cell_id}: cached, skipping")
                continue
            try:
                if args.opt:
                    apply_opt(arch)
                run_cell(arch, shape_name, multi, art_dir=args.outdir)
            except Exception as e:
                traceback.print_exc()
                failures.append((cell_id, repr(e)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        print(f"\n[dryrun] {len(failures)} FAILED cells:")
        for cid, err in failures:
            print(f"  {cid}: {err[:200]}")
        raise SystemExit(1)
    print("\n[dryrun] all requested cells counted OK")


if __name__ == "__main__":
    main()
