"""Collective bytes of each place where the port's mesh path works around
a missing DTensor rule, one device's share, counted on ``meta``.

Each place runs alone, once, at a production cell's full size on the
16x16 ``(data, model)`` mesh (built over a fake process group of 256
ranks, as the dry run builds it), its inputs laid out as that cell's
step lays them out (a layer's params with their FSDP split gathered, as
each block gathers them before use), under ``core.profiler``'s counting
mode:

* ``moe_apply``: the per-row top-k, dispatch and combine on local rows
  (``sort``, ``searchsorted``, ``scatter``, ``gather``): one MoE layer of
  qwen2-moe-a2.7b (experts split over their width) and of
  deepseek-v3-671b (experts split over ``model``), ``decode_32k``;
* ``gqa_decode``: the cache writes and the decode attention on local
  shards, for a cache split over heads (stablelm-1.6b, 32 KV heads) and
  over the head dim (qwen2-72b, 8 KV heads: a partial score summed across
  ``model``), ``decode_32k``;
* ``mla_decode``: the latent cache's write on local shards; its slice
  into compressed and rotary parts gathers the latent cache whole
  (deepseek-v3-671b ``decode_32k``);
* ``_qkv``: a head split ``model`` does not divide (qwen2-72b's 8 KV
  heads over 16) gathers K and V first (``distributed.sharding.reshape``),
  one layer of ``prefill_32k``;
* the cross-entropy chunk's ``logsumexp`` over a vocab split
  (``launch.dryrun.ce_chunk_count``), stablelm-1.6b ``train_4k``.

Run:  PYTHONPATH=src python tools/dtensor_places.py [--out FILE]
Prints one line a place and writes them as JSON (default
``build/dtensor_places.json``).
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch import configs as cfgs
from repro_torch.distributed.sharding import gather_fsdp, meta_tree
from repro_torch.distributed.specs import cache_pspecs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention as attn
from repro_torch.models import LM
from repro_torch.models.moe import moe_apply
from repro_torch.models.params import (compute_params, map_tree,
                                       param_pspecs, param_shape_structs)

OUT = os.path.join(os.path.dirname(__file__), "..", "build",
                   "dtensor_places.json")


def _layer(tree, specs, section="stack", key=None):
    """Layer 0 of a stacked section's params and specs (the layer axis
    dropped)."""
    t, s = tree[section], specs[section]
    key = key or sorted(t)[0]
    return (map_tree(lambda x: x[0], t[key]),
            map_tree(lambda sp: sp[1:], s[key]))


def _params(cfg, mesh):
    fsdp = 16 if cfg.param_dtype == "bfloat16" else 0
    specs = param_pspecs(cfg, fsdp_size=fsdp, tp_size=16)
    return compute_params(cfg, param_shape_structs(cfg)), specs


def _x(cfg, b, s, mesh):
    """The residual stream (B, S, D) batch-split over ``data``."""
    x = torch.empty((b, s, cfg.d_model), dtype=cfg.activation_dtype,
                    device="meta")
    lead = "data" if b % 32 == 0 else None
    return meta_tree(x, (lead, None, None), mesh)


def _gathered(tree, specs, mesh):
    """A layer's params on ``meta`` shards, their FSDP split gathered as
    the block gathers it before use (not counted here)."""
    return gather_fsdp(meta_tree(tree, specs, mesh))


def _count(mesh, fn):
    return {k: float(v) for k, v in
            sorted(dryrun.count_on_mesh(mesh, fn).collectives.items())}


def moe_place(arch, mesh):
    cfg = cfgs.get_config(arch)
    sh = cfgs.SHAPES["decode_32k"]
    params, specs = _params(cfg, mesh)
    key = next(k for k in sorted(params["stack"]) if k.endswith("attn"))
    p, ps = _layer(params, specs, key=key)
    p = _gathered(p["mlp"], ps["mlp"], mesh)
    x = _x(cfg, sh.global_batch, 1, mesh)
    return _count(mesh, lambda: moe_apply(cfg, p, x))


def _decode_cache(cfg, sh, mesh):
    cache = LM(cfg).init_cache(sh.global_batch, sh.seq_len, device="meta")
    specs = cache_pspecs(cfg, cache, ("data", "model"), 16, sh.global_batch)
    c, cs = _layer(cache, specs)
    return meta_tree(c, cs, mesh), meta_tree(
        cache["pos"], specs["pos"], mesh)


def gqa_decode_place(arch, mesh):
    cfg = cfgs.get_config(arch)
    sh = cfgs.SHAPES["decode_32k"]
    params, specs = _params(cfg, mesh)
    p, ps = _layer(params, specs)
    p = _gathered(p["attn"], ps["attn"], mesh)
    cache, pos = _decode_cache(cfg, sh, mesh)
    x = _x(cfg, sh.global_batch, 1, mesh)
    return _count(mesh, lambda: attn.gqa_decode(cfg, p, x, cache, pos))


def mla_decode_place(arch, mesh):
    cfg = cfgs.get_config(arch)
    sh = cfgs.SHAPES["decode_32k"]
    params, specs = _params(cfg, mesh)
    p, ps = _layer(params, specs)
    p = _gathered(p["attn"], ps["attn"], mesh)
    cache, pos = _decode_cache(cfg, sh, mesh)
    x = _x(cfg, sh.global_batch, 1, mesh)
    return _count(mesh, lambda: attn.mla_decode(cfg, p, x, cache, pos))


def qkv_place(arch, mesh):
    cfg = cfgs.get_config(arch)
    sh = cfgs.SHAPES["prefill_32k"]
    params, specs = _params(cfg, mesh)
    p, ps = _layer(params, specs)
    p = _gathered(p["attn"], ps["attn"], mesh)
    x = _x(cfg, sh.global_batch, sh.seq_len, mesh)
    return _count(mesh, lambda: attn._qkv(cfg, p, x))


def ce_place(arch, mesh):
    cell = dryrun.build_cell(arch, "train_4k", mesh)
    got = dryrun.ce_chunk_count(cell, cfgs.get_config(arch), mesh)
    return {k: float(v) for k, v in sorted(got.collectives.items())}


PLACES = (
    ("moe_apply (experts split over their width)", moe_place,
     "qwen2-moe-a2.7b", "decode_32k, one MoE layer"),
    ("moe_apply (experts split over model)", moe_place,
     "deepseek-v3-671b", "decode_32k, one MoE layer"),
    ("gqa_decode (cache split over heads)", gqa_decode_place,
     "stablelm-1.6b", "decode_32k, one layer"),
    ("gqa_decode (cache split over the head dim)", gqa_decode_place,
     "qwen2-72b", "decode_32k, one layer"),
    ("mla_decode (latent sliced whole)", mla_decode_place,
     "deepseek-v3-671b", "decode_32k, one MoE layer's attention"),
    ("_qkv (8 KV heads over 16)", qkv_place, "qwen2-72b",
     "prefill_32k, one layer"),
    ("cross-entropy chunk (logsumexp over a vocab split)", ce_place,
     "stablelm-1.6b", "train_4k, one chunk's forward"),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    dryrun._ensure_world()
    mesh = make_production_mesh(multi_pod=False)
    rows = []
    for name, fn, arch, where in PLACES:
        got = fn(arch, mesh)
        rows.append({"place": name, "arch": arch, "where": where,
                     "collective_bytes": got,
                     "total": sum(got.values())})
        print(f"{name}: {arch} {where}: " + (", ".join(
            f"{k} {v:,.0f} B" for k, v in got.items()) or "none")
            + " a device")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
