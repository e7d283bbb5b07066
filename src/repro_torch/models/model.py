"""Model assembly: block dispatch, the layer stack, prefill and decode.

The reference compiles the stack as ``prefix + lax.scan over super-blocks
+ tail``; the port walks the same stacked parameters with a Python loop
over the layer axis (one ``unbind`` of each stacked leaf per traversal,
so that backward stacks the layers' gradients once).  Its sharding
constraints are identity off a mesh and are left out.  The port runs the
dense ``attn`` block kind only: ``LM`` refuses any other config
(``params.check_ported``).

Entry points:
  ``loss``         — training forward: every stacked block under
                     ``torch.utils.checkpoint`` (the reference's default
                     "full" remat policy), chunked cross-entropy; every
                     layer's attention goes through the flash-attention
                     kernel and its CUDA backward
  ``prefill``      — full-sequence forward that also builds the decode
                     cache; every layer's attention goes through the
                     flash-attention kernel
  ``decode_step``  — one new token against the cache (updated in place)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (chunked_ce_loss, embed_tokens,
                                       mlp_apply, rms_norm)
from repro_torch.models.params import check_ported, map_tree

__all__ = ["LM"]


def _ordered(section: dict) -> list[str]:
    return sorted(section, key=lambda s: int(s.split("_")[0]))


# --------------------------------------------------------------------------- #
# single-block apply                                                           #
# --------------------------------------------------------------------------- #


def _block_full(cfg: ModelConfig, p: dict, x: torch.Tensor, *, pos0: int,
                build_cache: bool):
    """One attention block over the whole sequence.  Returns
    (x, cache_or_None)."""
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    cache = None
    if build_cache:
        y, (k, v) = attn.gqa_full(cfg, p["attn"], h_in, pos0=pos0,
                                  window=cfg.local_window, return_cache=True)
        cache = {"k": k, "v": v}
    else:
        y = attn.gqa_full(cfg, p["attn"], h_in, pos0=pos0,
                          window=cfg.local_window)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(cfg, p["mlp"], h2), cache


def _block_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                  pos: torch.Tensor):
    """One attention block, one token.  Returns (x, cache) with ``cache``
    updated in place."""
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, cache = attn.gqa_decode(cfg, p["attn"], h_in, cache, pos,
                               window=cfg.local_window)
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + mlp_apply(cfg, p["mlp"], h2), cache


def _cache_from_prefill(cfg: ModelConfig, built: dict, batch: int, seq: int,
                        max_len: int, device: torch.device) -> dict:
    """A prefill-built (k, v) of ``seq`` positions as a decode cache of
    ``max_len`` (a ring of the last ``window`` positions when windowed)."""
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
    def _sections(self, params: dict):
        """(section, key, layer index or None, layer params) in order."""
        for section in ("prefix", "stack", "tail"):
            if section not in params:
                continue
            if section == "stack":
                layers = map_tree(lambda t: t.unbind(0), params["stack"])
                for i in range(self.cfg.layer_plan().n_super):
                    lp = map_tree(lambda ts: ts[i], layers)
                    for key in _ordered(lp):
                        yield section, key, i, lp[key]
            else:
                for key in _ordered(params[section]):
                    yield section, key, None, params[section][key]

    def _forward(self, params: dict, x: torch.Tensor, *,
                 build_cache: bool = False, remat: bool = False):
        """Shared full-sequence traversal.  Returns (x, caches): caches in
        the reference's layout, stacked layers on a leading axis.  With
        ``remat`` every stacked block runs under ``torch.utils.checkpoint``
        (backward recomputes it), as the reference checkpoints its scan
        body."""
        cfg = self.cfg
        caches: dict[str, Any] = {}
        stack: dict[str, list] = {}
        for section, key, i, lp in self._sections(params):
            if remat and i is not None and not build_cache:
                # bind lp now: the recompute runs after the loop has moved on
                x, c = checkpoint(functools.partial(
                    _block_full, cfg, lp, pos0=0, build_cache=False), x,
                    use_reentrant=False)
            else:
                x, c = _block_full(cfg, lp, x, pos0=0,
                                   build_cache=build_cache)
            if not build_cache:
                continue
            if i is None:
                caches.setdefault(section, {})[key] = c
            else:
                stack.setdefault(key, []).append(c)
        if stack:
            caches["stack"] = {k: _stacked(v) for k, v in stack.items()}
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, caches

    def _head(self, params: dict) -> torch.Tensor:
        return params["embed"] if self.cfg.tie_embeddings else params["head"]

    # ----- public entry points ---------------------------------------------------
    def loss(self, params: dict, batch: dict, *, remat: bool = True):
        """Mean next-token cross-entropy of ``batch`` ({"tokens",
        "labels"}, labels -1 ignored).  Returns (ce + aux, {"ce_sum",
        "n_tokens", "aux_loss"}); aux is 0 for the dense models.

        ``params`` are the float32 master weights, not ``compute_params``:
        each call casts them to the activation dtype inside the graph, so
        that gradients land on the float32 leaves.  ``remat`` is the
        reference's default "full" policy; its ``REPRO_REMAT_POLICY`` and
        ``REPRO_REMAT_GROUP`` switches are not ported."""
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
                    cfg, built[section][key], b, s, max_len, device)
                    for key in built[section]}
        if "stack" in built:
            out["stack"] = {}
            for key, layers in built["stack"].items():
                n = layers["k"].shape[0]
                out["stack"][key] = _stacked([_cache_from_prefill(
                    cfg, _layer(layers, i), b, s, max_len, device)
                    for i in range(n)])
        return out

    def init_cache(self, batch: int, max_len: int, *,
                   device: str | torch.device = "cuda") -> dict:
        cfg = self.cfg
        plan = cfg.layer_plan()
        device = torch.device(device)

        def one() -> dict:
            return attn.init_gqa_cache(cfg, batch, max_len, cfg.local_window,
                                       device=device)

        out: dict[str, Any] = {"pos": torch.zeros((batch,), dtype=torch.int64,
                                                  device=device)}
        if plan.prefix:
            out["prefix"] = {f"{i}_{k}": one()
                             for i, k in enumerate(plan.prefix)}
        if plan.n_super:
            out["stack"] = {f"{i}_{k}": _stacked([one()] * plan.n_super)
                            for i, k in enumerate(plan.super_block)}
        if plan.tail:
            out["tail"] = {f"{i}_{k}": one()
                           for i, k in enumerate(plan.tail)}
        return out

    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """tokens: (B, 1).  Returns (logits (B, V), cache): the layer caches
        are updated in place and ``pos`` advances by one."""
        cfg = self.cfg
        pos = cache["pos"]
        x = embed_tokens(cfg, params["embed"], tokens)
        for section, key, i, lp in self._sections(params):
            lc = cache[section][key] if i is None \
                else _layer(cache[section][key], i)
            x, _ = _block_decode(cfg, lp, x, lc, pos)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = (x[:, 0, :] @ self._head(params).to(x.dtype).T).to(
            torch.float32)
        new_cache = dict(cache, pos=pos + 1)
        return logits[:, : cfg.vocab_size], new_cache

