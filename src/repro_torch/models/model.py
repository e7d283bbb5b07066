"""Model assembly: block dispatch, the layer stack, prefill and decode.

The reference compiles the stack as ``prefix + lax.scan over super-blocks
+ tail``; the port walks the same stacked parameters with a Python loop
over the layer axis (one ``unbind`` of each stacked leaf per traversal,
so that backward stacks the layers' gradients once).  Its sharding
constraints are the reference's (``distributed.sharding.constrain`` on the
embedded inputs, ``constrain_residual`` at each block's entry): the
identity off a mesh, a DTensor redistribute under one.  The port runs the
``attn`` block kind (GQA or MLA attention, a dense MLP or a mixture of
experts) and the recurrent kinds ``rglru``, ``mlstm`` and ``slstm``.  A
MoE config's attention blocks take the experts except in the ``prefix``
section (DeepSeek-V3's ``dense_prefix`` layers), as in the reference,
and their load-balance losses add up to the loss's ``aux``.

Inputs, as the reference takes them: ``tokens`` always; an
encoder-decoder config (seamless-m4t-large-v2) also ``frames`` (B, F, D),
projected by ``frontend.adapter`` and encoded by ``encoder`` (dense
attention blocks, non-causal, RoPE from position 0) into the memory every
decoder block cross-attends to (``ln_x`` -> ``xattn`` after its
self-attention); a vision config (llava-next-34b) ``patches`` (B, P, D),
projected by the adapter and put before the token embeddings, with the
labels padded by -1 over them.  ``prefill`` keeps the encoder memory in
the cache (``enc_out``) and ``decode_step`` carries it.

Entry points:
  ``loss``         — training forward: every stacked block under
                     ``torch.utils.checkpoint`` (the reference's
                     ``REPRO_REMAT_POLICY`` and ``REPRO_REMAT_GROUP``
                     switches, below), chunked cross-entropy; every
                     layer's attention goes through the flash-attention
                     kernel and its CUDA backward
  ``prefill``      — full-sequence forward that also builds the decode
                     cache (k/v for GQA, the latent for MLA, the
                     recurrent states, the encoder memory);
                     every layer's attention goes through the
                     flash-attention kernel
  ``decode_step``  — one new token against the cache (updated in place);
                     an encoder-decoder's cross-attention goes through
                     the flash-attention kernel at one query

Rematerialization, read from the environment on each forward, as the
reference reads it when it traces:
  ``REPRO_REMAT_POLICY=full`` (default) recomputes every stacked block in
  backward; ``=dots`` saves the outputs of matmuls with no batch dims
  (``aten.mm`` / ``aten.addmm``, the reference's
  ``dots_with_no_batch_dims_saveable``) and recomputes the rest (the
  experts' products are batched over experts, so they are recomputed).
  ``REPRO_REMAT_GROUP=g`` (> 1, with g dividing the super-block count)
  adds a second level: each group of g super-blocks is checkpointed
  whole, so the forward keeps only the groups' inputs and the backward
  recomputes one group at a time.
The port checkpoints each block of a super-block on its own where the
reference checkpoints the super-block whole: the same numbers, with one
block's activations live in a recompute, not a super-block's.  Under
``remat`` each encoder layer is checkpointed too (the reference
checkpoints its encoder scan's body).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import (constrain, constrain_residual,
                                              gather_fsdp, like_layout,
                                              mesh_ops, on_local,
                                              pin_residual)
from repro_torch.models import attention as attn
from repro_torch.models import recurrent as rec
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (chunked_ce_loss, embed_tokens,
                                       mlp_apply, rms_norm)
from repro_torch.models.moe import moe_apply
from repro_torch.models.params import map_tree

__all__ = ["LM"]

RECURRENT_KINDS = ("rglru", "mlstm", "slstm")


def _ordered(section: dict) -> list[str]:
    return sorted(section, key=lambda s: int(s.split("_")[0]))


def _kind(key: str) -> str:
    return key.split("_", 1)[1]


# --------------------------------------------------------------------------- #
# single-block apply                                                           #
# --------------------------------------------------------------------------- #


def _block_rest(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, *,
                dense: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """A block's second residual half, after its mixer: the MLP or the
    experts (attn; the experts unless ``dense``), the MLP (rglru), sLSTM's
    gated FFN, or nothing (mLSTM).  Returns (x, the experts' load-balance
    loss or None)."""
    if kind == "mlstm":
        return x, None
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "slstm":
        return x + rec.slstm_ffn(p["slstm"], h2), None
    if kind == "attn" and cfg.moe is not None and not dense:
        y, aux = moe_apply(cfg, p["mlp"], h2)
        return x + y, aux
    return x + mlp_apply(cfg, p["mlp"], h2), None


def _block_full(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor, *,
                pos0: int, dense: bool, build_cache: bool,
                enc_out: torch.Tensor | None = None, causal: bool = True):
    """One block of ``kind`` over the whole sequence (an attention block
    cross-attends to ``enc_out`` when it has ``xattn``; ``causal`` False
    for the encoder's).  Returns (x, aux_loss or None, cache_or_None)."""
    p = gather_fsdp(p)
    x = constrain_residual(x)
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    cache = None
    if kind == "attn" and cfg.mla is not None:
        y = attn.mla_full(cfg, p["attn"], h_in, pos0=pos0,
                          return_cache=build_cache)
        if build_cache:
            y, latent = y
            cache = {"latent": latent}
    elif kind == "attn":
        y = attn.gqa_full(cfg, p["attn"], h_in, pos0=pos0,
                          window=cfg.local_window, causal=causal,
                          return_cache=build_cache)
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
    x = pin_residual(x + y)
    if enc_out is not None and "xattn" in p:
        xh = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = pin_residual(x + attn.gqa_full(cfg, p["xattn"], xh,
                                           cross_kv=enc_out, causal=False,
                                           use_rope=False))
    x, aux = _block_rest(cfg, kind, p, x, dense=dense)
    return pin_residual(x), aux, cache


def _block_decode(cfg: ModelConfig, kind: str, p: dict, x: torch.Tensor,
                  cache: dict, pos: torch.Tensor, *, dense: bool,
                  enc_out: torch.Tensor | None = None):
    """One block, one token (cross-attending to ``enc_out`` where the
    block has ``xattn``).  Returns (x, cache): an attention block's cache
    updated in place, a recurrent block's new state (the caller writes it
    back)."""
    p = gather_fsdp(p)
    h_in = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "attn" and cfg.mla is not None:
        y, cache = attn.mla_decode(cfg, p["attn"], h_in, cache, pos)
    elif kind == "attn":
        y, cache = attn.gqa_decode(cfg, p["attn"], h_in, cache, pos,
                                   window=cfg.local_window)
    elif kind in RECURRENT_KINDS:
        y, cache = getattr(rec, f"{kind}_decode")(cfg, p[kind], h_in, cache)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    x = pin_residual(x + y)
    if enc_out is not None and "xattn" in p:
        xh = rms_norm(x, p["ln_x"], cfg.norm_eps)
        x = pin_residual(x + attn.gqa_decode_cross(cfg, p["xattn"], xh,
                                                   enc_out))
    return pin_residual(_block_rest(cfg, kind, p, x, dense=dense)[0]), cache


def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      device: torch.device) -> dict:
    if kind == "attn" and cfg.mla is not None:
        return attn.init_mla_cache(cfg, batch, max_len, device=device)
    if kind == "attn":
        return attn.init_gqa_cache(cfg, batch, max_len, cfg.local_window,
                                   device=device)
    if kind not in RECURRENT_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")
    return getattr(rec, f"init_{kind}_state")(cfg, batch, device=device)


def _cache_from_prefill(cfg: ModelConfig, kind: str, built: dict,
                        max_len: int) -> dict:
    """A prefill-built layer cache as a decode cache: an MLA layer's latent
    of ``seq`` positions, or a GQA layer's (k, v), in a cache of
    ``max_len`` (a ring of the last ``window`` positions when windowed); a
    recurrent layer's state carries over unchanged.  Under a mesh each
    device builds its own shards' cache, laid out as the built tensors
    (DTensor has no rule for an indexed write)."""
    if kind != "attn":
        return built
    if cfg.mla is not None:
        lay = like_layout(built["latent"], {0: 0, 1: 1, 2: 2})
        return {"latent": on_local(
            lambda lat: _latent_cache(cfg, lat, max_len),
            (built["latent"],), (lay,), lay)}
    lay = like_layout(built["k"], {0: 0, 1: 1, 3: 3})
    k, v, slot_pos = on_local(
        lambda k, v: _gqa_cache(cfg, k, v, max_len), (built["k"], built["v"]),
        (lay, lay), (lay, lay, like_layout(built["k"], {0: 0})))
    return {"k": k, "v": v, "slot_pos": slot_pos}


def _latent_cache(cfg: ModelConfig, latent: torch.Tensor,
                  max_len: int) -> torch.Tensor:
    """An MLA decode cache of ``max_len`` holding ``latent`` (B, S, D_lat)
    at its first S positions."""
    b, s, dl = latent.shape          # a device's shard under a mesh
    cache = attn.init_mla_cache(cfg, b, max_len, dim=dl,
                                device=latent.device)["latent"]
    cache[:, :s] = latent
    return cache


def _gqa_cache(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor,
               max_len: int) -> tuple[torch.Tensor, ...]:
    """A GQA decode cache (k, v, slot_pos) of ``max_len`` holding the
    prefill's k, v (B, Hkv, S, hd)."""
    batch, hk, seq, hd = k.shape     # a device's shard under a mesh
    cache = attn.init_gqa_cache(cfg, batch, max_len, cfg.local_window,
                                heads=hk, head_dim=hd, device=k.device)
    size = cache["k"].shape[2]
    k = k.to(cache["k"].dtype)
    v = v.to(cache["v"].dtype)
    if cfg.local_window > 0 and seq > size:
        # keep the last `size` positions, ring-aligned: slot = pos % size
        positions = torch.arange(seq - size, seq, device=k.device)
        slots = positions % size
        cache["k"][:, :, slots, :] = k[:, :, -size:, :]
        cache["v"][:, :, slots, :] = v[:, :, -size:, :]
        cache["slot_pos"][:, slots] = positions
    else:
        cache["k"][:, :, :seq, :] = k
        cache["v"][:, :, :seq, :] = v
        cache["slot_pos"][:, :seq] = torch.arange(seq, device=k.device)
    return cache["k"], cache["v"], cache["slot_pos"]


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

    # ----- input embedding / frontends ---------------------------------------
    def _inputs(self, params: dict, batch: dict, *, remat: bool = False):
        """Returns (x, labels or None, enc_out or None): the token
        embeddings (after the projected patches of a vision config, whose
        labels are padded with -1 over them) and an encoder-decoder
        config's encoded frames."""
        cfg = self.cfg
        labels = batch.get("labels")
        enc_out = None
        if cfg.is_encdec:
            frames = batch["frames"].to(cfg.activation_dtype)
            frames = frames @ gather_fsdp(
                params["frontend"]["adapter"]).to(frames.dtype)
            enc_out = self._encode(params, frames, remat=remat)
        x = embed_tokens(cfg, gather_fsdp(params["embed"]),
                         batch["tokens"])
        if cfg.frontend == "vision":
            patches = batch["patches"].to(cfg.activation_dtype)
            patches = patches @ gather_fsdp(
                params["frontend"]["adapter"]).to(patches.dtype)
            if isinstance(x, DTensor) and any(p.is_partial()
                                              for p in x.placements):
                # the embedding's masked partial (a vocab split; torch
                # 2.11 keeps it through the cast) reduced to the residual
                # stream's layout before the cat, as the constrain below
                # would reduce it: a cat of a masked partial reaches
                # aten::equal, which has no meta kernel there
                x = constrain(x, ("pod", "data"), None, None)
            x = torch.cat([patches, x], dim=1)
            if labels is not None:
                pad = torch.full(patches.shape[:2], -1, dtype=labels.dtype,
                                 device=labels.device)
                labels = torch.cat([pad, labels], dim=1)
        x = constrain(x, ("pod", "data"), None, None)
        return x, labels, enc_out

    def _encode(self, params: dict, frames: torch.Tensor, *,
                remat: bool = False) -> torch.Tensor:
        """The encoder: its dense attention blocks, non-causal with RoPE
        from position 0, then its final norm; with ``remat`` each layer
        under ``torch.utils.checkpoint``."""
        cfg = self.cfg
        enc = params["encoder"]
        layers = map_tree(lambda t: t.unbind(0), enc["stack"]["0_attn"])
        x = frames
        for i in range(cfg.encoder_layers):
            block = functools.partial(
                _block_full, cfg, "attn", map_tree(lambda ts: ts[i], layers),
                pos0=0, dense=True, build_cache=False, causal=False)
            x = (checkpoint(block, x, use_reentrant=False) if remat
                 else block(x))[0]
        return rms_norm(x, gather_fsdp(enc["final_norm"]), cfg.norm_eps)

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

    def _remat_super(self, sp: dict, x: torch.Tensor, aux: torch.Tensor,
                     context_fn=None, enc_out: torch.Tensor | None = None,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """One super-block, each block under ``torch.utils.checkpoint``
        (``context_fn`` picks what a block keeps).  Returns (x, aux plus
        the blocks' load-balance losses)."""
        kw = {} if context_fn is None else {"context_fn": context_fn}
        for key in _ordered(sp):
            # bind the block now: the recompute runs after the loop moved on
            x, a, _ = checkpoint(functools.partial(
                _block_full, self.cfg, _kind(key), sp[key], pos0=0,
                dense=False, build_cache=False, enc_out=enc_out), x,
                use_reentrant=False, **kw)
            if a is not None:
                aux = aux + a
        return x, aux

    def _remat_stack(self, params: dict, x: torch.Tensor, aux: torch.Tensor,
                     enc_out: torch.Tensor | None = None,
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """The stacked section under the remat switches, read as the
        reference reads them."""
        group = int(os.environ.get("REPRO_REMAT_GROUP", "1"))
        context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                        _save_dots)
                      if os.environ.get("REPRO_REMAT_POLICY") == "dots"
                      else None)
        supers = self._super_blocks(params)
        if group > 1 and len(supers) % group == 0:
            def run_group(xx, aa, members):
                for sp in members:
                    xx, aa = self._remat_super(sp, xx, aa, context_fn,
                                               enc_out)
                return xx, aa

            for g0 in range(0, len(supers), group):
                x, aux = checkpoint(run_group, x, aux,
                                    supers[g0:g0 + group],
                                    use_reentrant=False)
            return x, aux
        for sp in supers:
            x, aux = self._remat_super(sp, x, aux, context_fn, enc_out)
        return x, aux

    def _forward(self, params: dict, x: torch.Tensor, *,
                 enc_out: torch.Tensor | None = None,
                 build_cache: bool = False, remat: bool = False):
        """Shared full-sequence traversal (every block with an ``xattn``
        cross-attends to ``enc_out``).  Returns (x, aux, caches): aux
        the sum of the MoE blocks' load-balance losses (float32, 0 without
        experts), caches in the reference's layout, stacked layers on a
        leading axis.  With ``remat`` (and no cache to build) the stacked
        blocks run under ``torch.utils.checkpoint`` (backward recomputes
        them), as the reference checkpoints its scan body."""
        cfg = self.cfg
        caches: dict[str, Any] = {}
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for section in ("prefix", "stack", "tail"):
            if section not in params:
                continue
            if section == "stack" and remat and not build_cache:
                x, aux = self._remat_stack(params, x, aux, enc_out)
                continue
            if section == "stack":
                blocks = [(key, sp[key]) for sp in self._super_blocks(params)
                          for key in _ordered(sp)]
            else:
                blocks = [(key, params[section][key])
                          for key in _ordered(params[section])]
            built: dict[str, list] = {}
            for key, lp in blocks:
                x, a, c = _block_full(cfg, _kind(key), lp, x, pos0=0,
                                      dense=section == "prefix",
                                      build_cache=build_cache,
                                      enc_out=enc_out)
                if a is not None:
                    aux = aux + a
                built.setdefault(key, []).append(c)
            if build_cache:
                caches[section] = {
                    k: _stacked(v) if section == "stack" else v[0]
                    for k, v in built.items()}
        x = rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps)
        return x, aux, caches

    def _head(self, params: dict) -> torch.Tensor:
        return gather_fsdp(params["embed"] if self.cfg.tie_embeddings
                           else params["head"])

    # ----- public entry points ---------------------------------------------------
    def loss(self, params: dict, batch: dict, *, remat: bool = True):
        """Mean next-token cross-entropy of ``batch`` ({"tokens",
        "labels"}, labels -1 ignored, plus "frames" or "patches" where the
        config takes them).  Returns (ce + aux, {"ce_sum", "n_tokens",
        "aux_loss"}): aux the MoE blocks' load-balance losses summed, 0 for
        the other models.

        ``params`` are the float32 master weights, not ``compute_params``:
        each call casts them to the activation dtype inside the graph, so
        that gradients land on the float32 leaves.  ``remat`` checkpoints
        the stacked blocks under the ``REPRO_REMAT_POLICY`` and
        ``REPRO_REMAT_GROUP`` switches (module docstring)."""
        cfg = self.cfg
        x, labels, enc_out = self._inputs(params, batch, remat=remat)
        x, aux, _ = self._forward(params, x, enc_out=enc_out, remat=remat)
        ce, metrics = chunked_ce_loss(cfg, self._head(params), x, labels)
        metrics["aux_loss"] = aux
        return ce + aux, metrics

    def prefill(self, params: dict, batch: dict, *, max_len: int):
        """Forward + cache build.  Returns (cache, last-position logits);
        an encoder-decoder's cache keeps the encoder memory (``enc_out``)
        for decode's cross-attention.  On DTensor trees under a mesh it
        runs under ``distributed.sharding.mesh_ops``."""
        with mesh_ops():
            return self._prefill(params, batch, max_len=max_len)

    def _prefill(self, params: dict, batch: dict, *, max_len: int):
        cfg = self.cfg
        x, _, enc_out = self._inputs(params, batch)
        b, s, _ = x.shape
        x, _, built = self._forward(params, x, enc_out=enc_out,
                                    build_cache=True)
        cache = self._caches_to_decode(built, max_len)
        cache["pos"] = torch.full((b,), s, dtype=torch.int64,
                                  device=x.device)   # per-lane positions
        if enc_out is not None:
            cache["enc_out"] = enc_out
        logits = (x[:, -1, :] @ self._head(params).to(x.dtype).T).to(
            torch.float32)
        return cache, logits[:, : cfg.vocab_size]

    def _caches_to_decode(self, built: dict, max_len: int) -> dict:
        cfg = self.cfg
        out: dict[str, Any] = {}
        for section in ("prefix", "tail"):
            if section in built:
                out[section] = {key: _cache_from_prefill(
                    cfg, _kind(key), built[section][key], max_len)
                    for key in built[section]}
        if "stack" in built:
            out["stack"] = {}
            for key, layers in built["stack"].items():
                if _kind(key) != "attn":
                    out["stack"][key] = layers   # states carry over
                    continue
                out["stack"][key] = _stacked([_cache_from_prefill(
                    cfg, "attn", _layer(layers, i), max_len)
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
        stacked layer are views of the stacked state.  An encoder-decoder's
        cache carries ``enc_out`` through unchanged."""
        with mesh_ops():
            return self._decode_step(params, cache, tokens)

    def _decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        cfg = self.cfg
        pos = cache["pos"]
        enc_out = cache.get("enc_out")
        x = embed_tokens(cfg, gather_fsdp(params["embed"]), tokens)
        # as ``_inputs`` pins it: on a mesh with a vocab-split table this
        # also sums the lookup's masked partial at once
        x = constrain(x, ("pod", "data"), None, None)
        for section, key, i, lp in self._sections(params):
            lc = cache[section][key] if i is None \
                else _layer(cache[section][key], i)
            x, new = _block_decode(cfg, _kind(key), lp, x, lc, pos,
                                   dense=section == "prefix",
                                   enc_out=enc_out)
            if new is not lc:
                for name, t in new.items():
                    lc[name].copy_(t)
        x = rms_norm(x, gather_fsdp(params["final_norm"]), cfg.norm_eps)
        logits = (x[:, 0, :] @ self._head(params).to(x.dtype).T).to(
            torch.float32)
        new_cache = dict(cache, pos=pos + 1)
        return logits[:, : cfg.vocab_size], new_cache
