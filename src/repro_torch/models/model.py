"""Model assembly: block dispatch, the layer stack, prefill and decode.

The reference compiles the stack as ``prefix + lax.scan over super-blocks
+ tail``; the port walks the same stacked parameters with a Python loop
over the layer axis (one ``unbind`` of each stacked leaf per traversal,
so that backward stacks the layers' gradients once).  Its sharding
constraints are identity off a mesh and are left out.  The port runs the
dense ``attn`` block kind and the recurrent kinds ``rglru``, ``mlstm``
and ``slstm``: ``LM`` refuses MoE, MLA, encoder-decoder and frontend
configs (``params.check_ported``).

Entry points:
  ``loss``         — training forward: every stacked block under
                     ``torch.utils.checkpoint`` (the reference's
                     ``REPRO_REMAT_POLICY`` and ``REPRO_REMAT_GROUP``
                     switches, below), chunked cross-entropy; every
                     layer's attention goes through the flash-attention
                     kernel and its CUDA backward
  ``prefill``      — full-sequence forward that also builds the decode
                     cache (k/v for attention, the recurrent states);
                     every layer's attention goes through the
                     flash-attention kernel
  ``decode_step``  — one new token against the cache (updated in place)

Rematerialization, read from the environment on each forward, as the
reference reads it when it traces:
  ``REPRO_REMAT_POLICY=full`` (default) recomputes every stacked block in
  backward; ``=dots`` saves the outputs of matmuls with no batch dims
  (``aten.mm`` / ``aten.addmm``, the reference's
  ``dots_with_no_batch_dims_saveable``) and recomputes the rest.
  ``REPRO_REMAT_GROUP=g`` (> 1, with g dividing the super-block count)
  adds a second level: each group of g super-blocks is checkpointed
  whole, so the forward keeps only the groups' inputs and the backward
  recomputes one group at a time.
The port checkpoints each block of a super-block on its own where the
reference checkpoints the super-block whole: the same numbers, with one
block's activations live in a recompute, not a super-block's.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (chunked_ce_loss, embed_tokens,
                                       mlp_apply, rms_norm)
from repro_torch.models.params import check_ported, map_tree

__all__ = ["LM"]

RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


def _ordered(section: dict) -> list[str]:
    return sorted(section, key=lambda s: int(s.split("_")[0]))


def _kind(key: str) -> str:
    return key.split("_", 1)[1]


# --------------------------------------------------------------------------- #
# single-block apply                                                           #
# --------------------------------------------------------------------------- #


def _block_rest(cfg: ModelConfig, kind: str, p: dict,
                x: torch.Tensor) -> torch.Tensor:
    """A block's second residual half, after its mixer: the MLP (attn,
    rglru), sLSTM's gated FFN, or nothing (mLSTM)."""
    if kind == "mlstm":
        return x
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "slstm":
        return x + rec.slstm_ffn(p["slstm"], h2)
    return x + mlp_apply(cfg, p["mlp"], h2)


def _block_full(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, *,
                pos0: int, build_cache: bool):
    """One block of ``kind`` over the whole sequence.  Returns
    (x, cache_or_None)."""
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    cache = None
    if kind == "attn":
        y = attn.gqa_full(cfg, p["attn"], h_in, pos0=pos0,
                          window=cfg.local_window, return_cache=build_cache)
        if build_cache:
            y, (k, v) = y
            cache = {"k": k, "v": v}
    elif kind in RECURRENT_KINDS:
        y = getattr(rec, f"{kind}_full")(cfg, p[kind], h_in,
                                         return_state=build_cache)
        if build_cache:
            y, cache = y
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return _block_rest(cfg, kind, p, x + y), cache


def _block_decode(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                  cache: dict, pos: torch.Tensor):
    """One block, one token.  Returns (x, cache): an attention block's
    cache updated in place, a recurrent block's new state (the caller
    writes it back)."""
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn":
        y, cache = attn.gqa_decode(cfg, p["attn"], h_in, cache, pos,
                                   window=cfg.local_window)
    elif kind in RECURRENT_KINDS:
        y, cache = getattr(rec, f"{kind}_decode")(cfg, p[kind], h_in, cache)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return _block_rest(cfg, kind, p, x + y), cache


def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      device: torch.device) -> dict:
    if kind == "attn":
        return attn.init_gqa_cache(cfg, batch, max_len, cfg.local_window,
                                   device=device)
    if kind not in RECURRENT_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    return getattr(rec, f"init_{kind}_state")(cfg, batch, device=device)


def _cache_from_prefill(cfg: ModelConfig, kind: str, built: dict, batch: int,
                        seq: int, max_len: int, device: torch.device) -> dict:
    """A prefill-built layer cache as a decode cache: an attention layer's
    (k, v) of ``seq`` positions in a cache of ``max_len`` (a ring of the
    last ``window`` positions when windowed); a recurrent layer's state
    carries over unchanged."""
    if kind != "attn":
        return built
    cache = attn.init_gqa_cache(cfg, batch, max_len, cfg.local_window,
                                device=device)
    size = cache["k"].shape[2]
    k = built["k"].to(cache["k"].dtype)
    v = built["v"].to(cache["v"].dtype)
    if cfg.local_window > 0 and seq > size:
        # keep the last `size` positions, ring-aligned: slot = pos % size
        positions = torch.arange(seq - size, seq, device=device)
        slots = positions % size
        cache["k"][:, :, slots, :] = k[:, :, -size:, :]
        cache["v"][:, :, slots, :] = v[:, :, -size:, :]
        cache["slot_pos"][:, slots] = positions
        return cache
    cache["k"][:, :, :seq, :] = k
    cache["v"][:, :, :seq, :] = v
    cache["slot_pos"][:, :seq] = torch.arange(seq, device=device)
    return cache


def _stacked(per_layer: list[dict]) -> dict:
    """Per-layer cache dicts stacked on a leading layer axis."""
    return map_tree(lambda *ts: torch.stack(ts), *per_layer)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, no copies)."""
    return map_tree(lambda t: t[i], tree)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``REPRO_REMAT_POLICY=dots``: keep what matmuls with no batch dims
    produce, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


# --------------------------------------------------------------------------- #
# whole model                                                                  #
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class LM:
    cfg: ModelConfig

    def __post_init__(self) -> None:
        check_ported(self.cfg)

    # ----- input embedding ---------------------------------------------------
    def _inputs(self, params: dict, batch: dict) -> torch.Tensor:
        return embed_tokens(self.cfg, params["embed"], batch["tokens"])

    # ----- layer-stack traversal ----------------------------------------------
    def _super_blocks(self, params: dict) -> list[dict]:
        """The stacked section's parameters, one dict per super-block."""
        if "stack" not in params:
            return []
        layers = map_tree(lambda t: t.unbind(0), params["stack"])
        return [map_tree(lambda ts: ts[i], layers)
                for i in range(self.cfg.layer_plan().n_super)]

    def _sections(self, params: dict):
        """(section, key, layer index or None, layer params) in order."""
        for section in ("prefix", "stack", "tail"):
            if section not in params:
                continue
            if section == "stack":
                for i, sp in enumerate(self._super_blocks(params)):
                    for key in _ordered(sp):
                        yield section, key, i, sp[key]
            else:
                for key in _ordered(params[section]):
                    yield section, key, None, params[section][key]

    def _remat_super(self, sp: dict, x: torch.Tensor,
                     context_fn=None) -> torch.Tensor:
        """One super-block, each block under ``torch.utils.checkpoint``
        (``context_fn`` picks what a block keeps)."""
        kw = {} if context_fn is None else {"context_fn": context_fn}
        for key in _ordered(sp):
            # bind the block now: the recompute runs after the loop moved on
            x, _ = checkpoint(functools.partial(
                _block_full, self.cfg, _kind(key), sp[key], pos0=0,
                build_cache=False), x, use_reentrant=False, **kw)
        return x

    def _remat_stack(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The stacked section under the remat switches, read as the
        reference reads them."""
        group = int(os.environ.get("REPRO_REMAT_GROUP", "1"))
        context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                        _save_dots)
                      if os.environ.get("REPRO_REMAT_POLICY") == "dots"
                      else None)
        supers = self._super_blocks(params)
        if group > 1 and len(supers) % group == 0:
            def run_group(xx, members):
                for sp in members:
                    xx = self._remat_super(sp, xx, context_fn)
                return xx

            for g0 in range(0, len(supers), group):
                x = checkpoint(run_group, x, supers[g0:g0 + group],
                               use_reentrant=False)
            return x
        for sp in supers:
            x = self._remat_super(sp, x, context_fn)
        return x

    def _forward(self, params: dict, x: torch.Tensor, *,
                 build_cache: bool = False, remat: bool = False):
        """Shared full-sequence traversal.  Returns (x, caches): caches in
        the reference's layout, stacked layers on a leading axis.  With
        ``remat`` (and no cache to build) the stacked blocks run under
        ``torch.utils.checkpoint`` (backward recomputes them), as the
        reference checkpoints its scan body."""
        cfg = self.cfg
        caches: dict[str, Any] = {}
        for section in ("prefix", "stack", "tail"):
            if section not in params:
                continue
            if section == "stack" and remat and not build_cache:
                x = self._remat_stack(params, x)
            elif section == "stack":
                built: dict[str, list] = {}
                for sp in self._super_blocks(params):
                    for key in _ordered(sp):
                        x, c = _block_full(cfg, _kind(key), sp[key], x,
                                           pos0=0, build_cache=build_cache)
                        built.setdefault(key, []).append(c)
                if build_cache:
                    caches["stack"] = {k: _stacked(v)
                                       for k, v in built.items()}
            else:
                for key in _ordered(params[section]):
                    x, c = _block_full(cfg, _kind(key), params[section][key],
                                       x, pos0=0, build_cache=build_cache)
                    if build_cache:
                        caches.setdefault(section, {})[key] = c
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, caches

    def _head(self, params: dict) -> torch.Tensor:
        return params["embed"] if self.cfg.tie_embeddings else params["head"]

    # ----- public entry points ---------------------------------------------------
    def loss(self, params: dict, batch: dict, *, remat: bool = True):
        """Mean next-token cross-entropy of ``batch`` ({"tokens",
        "labels"}, labels -1 ignored).  Returns (ce + aux, {"ce_sum",
        "n_tokens", "aux_loss"}); aux is 0 for the dense and recurrent
        models.

        ``params`` are the float32 master weights, not ``compute_params``:
        each call casts them to the activation dtype inside the graph, so
        that gradients land on the float32 leaves.  ``remat`` checkpoints
        the stacked blocks under the ``REPRO_REMAT_POLICY`` and
        ``REPRO_REMAT_GROUP`` switches (module docstring)."""
        cfg = self.cfg
        x = self._inputs(params, batch)
        x, _ = self._forward(params, x, remat=remat)
        ce, metrics = chunked_ce_loss(cfg, self._head(params), x,
                                      batch["labels"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        metrics["aux_loss"] = aux
        return ce + aux, metrics

    def prefill(self, params: dict, batch: dict, *, max_len: int):
        """Forward + cache build.  Returns (cache, last-position logits)."""
        cfg = self.cfg
        x = self._inputs(params, batch)
        b, s, _ = x.shape
        x, built = self._forward(params, x, build_cache=True)
        cache = self._caches_to_decode(built, b, s, max_len, x.device)
        cache["pos"] = torch.full((b,), s, dtype=torch.int64,
                                  device=x.device)   # per-lane positions
        logits = (x[:, -1, :] @ self._head(params).to(x.dtype).T).to(
            torch.float32)
        return cache, logits[:, : cfg.vocab_size]

    def _caches_to_decode(self, built: dict, b: int, s: int, max_len: int,
                          device: torch.device) -> dict:
        cfg = self.cfg
        out: dict[str, Any] = {}
        for section in ("prefix", "tail"):
            if section in built:
                out[section] = {key: _cache_from_prefill(
                    cfg, _kind(key), built[section][key], b, s, max_len,
                    device) for key in built[section]}
        if "stack" in built:
            out["stack"] = {}
            for key, layers in built["stack"].items():
                if _kind(key) != "attn":
                    out["stack"][key] = layers   # states carry over
                    continue
                out["stack"][key] = _stacked([_cache_from_prefill(
                    cfg, "attn", _layer(layers, i), b, s, max_len, device)
                    for i in range(cfg.layer_plan().n_super)])
        return out

    def init_cache(self, batch: int, max_len: int, *,
                   device: str | torch.device = "cuda") -> dict:
        cfg = self.cfg
        plan = cfg.layer_plan()
        device = torch.device(device)

        def one(kind: str) -> dict:
            return _init_block_cache(cfg, kind, batch, max_len, device)

        out: dict[str, Any] = {"pos": torch.zeros((batch,), dtype=torch.int64,
                                                  device=device)}
        if plan.prefix:
            out["prefix"] = {f"{i}_{k}": one(k)
                             for i, k in enumerate(plan.prefix)}
        if plan.n_super:
            out["stack"] = {f"{i}_{k}": _stacked([one(k)] * plan.n_super)
                            for i, k in enumerate(plan.super_block)}
        if plan.tail:
            out["tail"] = {f"{i}_{k}": one(k)
                           for i, k in enumerate(plan.tail)}
        return out

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens: (B, 1).  Returns (logits (B, V), cache): the layer caches
        are updated in place and ``pos`` advances by one.  A recurrent
        layer's new state is copied into its cache tensors, which for a
        stacked layer are views of the stacked state."""
        cfg = self.cfg
        pos = cache["pos"]
        x = embed_tokens(cfg, params["embed"], tokens)
        for section, key, i, lp in self._sections(params):
            lc = cache[section][key] if i is None \
                else _layer(cache[section][key], i)
            x, new = _block_decode(cfg, _kind(key), lp, x, lc, pos)
            if new is not lc:
                for name, t in new.items():
                    lc[name].copy_(t)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = (x[:, 0, :] @ self._head(params).to(x.dtype).T).to(
            torch.float32)
        new_cache = dict(cache, pos=pos + 1)
        return logits[:, : cfg.vocab_size], new_cache
