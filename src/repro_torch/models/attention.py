"""Attention: GQA (optional sliding window / bias / partial rotary) and
DeepSeek-V3 MLA, each with full-sequence and single-token-decode paths.

Full-sequence attention (``gqa_full`` and ``mla_full``: every prefill and
every training step) goes through the hand-written CUDA flash-attention
kernel (``kernels.ops.gqa_flash_attention``) where the reference runs its
chunked jnp path (``_sdpa_chunked``); query and key positions line up
there, which is what the kernel's causal mask assumes.  MLA's heads have a
q/k head dim of ``qk_head_dim`` (192 at full size) and a v head dim of
``v_head_dim`` (128): the kernel's wrapper takes Dv < D (on the card it
pads V with zero columns and drops them from the output).
``_sdpa_chunked`` stays here as the plain version, in the reference's
(B, S, H, hd) layout.  An encoder-decoder's cross-attention
(``gqa_full`` with ``cross_kv``: no RoPE, no mask, Lq != Lk) goes through
the same kernel, non-causal, so its masks' assumption of aligned
positions never applies.  Decode's self-attention (one query against the
cache) has no kernel in the reference either and stays plain tensor
code; decode's cross-attention (``gqa_decode_cross``) is ``gqa_full``, as
in the reference, so it launches the kernel at Lq = 1 against the whole
encoder memory and re-projects that memory's keys and values every step.

Decode caches:
  GQA:  k/v (B, Hkv, S_max, hd), written at ``pos`` per step.  Windowed
        layers use a ring buffer of size ``window`` plus a slot->absolute
        position buffer, so a long stream needs O(window) memory.
  MLA:  the compressed (B, S_max, kv_rank + rope_dim) latent cache; decode
        uses the *absorbed* form (scores via W_uk-absorbed queries against
        the latent cache, W_uv applied after) so neither K nor V is ever
        materialized.
Unlike the reference, whose arrays are immutable, ``gqa_decode`` and
``mla_decode`` write the new token into the cache in place and return the
same tensors: a copy of every layer's cache per token is what that saves.

Under a mesh (DTensor activations and caches, laid out by
``distributed.specs.cache_pspecs``) the cache writes run on each
device's own shards (``distributed.sharding.on_local``: DTensor has no
rule for an indexed write into a sharded tensor), the new token's key,
value or latent laid out as the cache first.  In the full-sequence
paths, query heads that ``model`` does not divide run padded
(``distributed.sharding.split_heads``: each device takes ceil(H / m)
heads, every group padded alike so that each real head keeps its KV
head), and the padded heads are dropped before ``w_o`` by an all-to-all
to its row split (``merge_heads``).  Elsewhere a head split the mesh
does not divide (the KV heads, decode's query heads), or a merge with a
split inner dim, all-gathers that dim first
(``distributed.sharding.reshape``).  MLA's absorbed decode slices
the latent cache, split over ``model`` along its last dim, into its
compressed and rotary parts: DTensor gathers it whole for that, every
step, and the dry run's count sees the gather.
"""

from __future__ import annotations

import torch

from torch.distributed.tensor import Partial, Shard

from repro_torch.distributed.sharding import (like_layout, merge_heads,
                                              on_local, reshape, split_heads)
from repro_torch.kernels import ops
from repro_torch.kernels.local_attention import local_flash_attention_plain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm, rope

__all__ = ["gqa_full", "gqa_decode", "gqa_decode_cross", "init_gqa_cache",
           "mla_full", "mla_decode", "init_mla_cache"]

_NEG = -1.0e30


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int) -> torch.Tensor:
    """q: (B,S,H,hd); k: (B,Sk,Hkv,hd), v: (B,Sk,Hkv,hdv), positions
    aligned at 0.  Returns (B,S,H,hdv): the plain version of what
    ``gqa_full`` and ``mla_full`` send to the kernel."""
    b, s, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    out = local_flash_attention_plain(
        q.transpose(1, 2).reshape(b * h, s, hd),
        k.transpose(1, 2).reshape(b * hkv, sk, hd),
        v.transpose(1, 2).reshape(b * hkv, sk, v.shape[-1]),
        window=window, causal=causal, kv_groups=h // hkv)
    return out.reshape(b, h, s, -1).transpose(1, 2)


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor,
         kv_x: torch.Tensor | None = None, *, pad: bool = False):
    """q from ``x``; k and v from ``kv_x`` (cross-attention's encoder
    memory), or from ``x`` when None.  ``pad``: q's heads split over
    ``model`` padded where it does not divide them
    (``sharding.split_heads``)."""
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kv_in = x if kv_x is None else kv_x
    q = x @ p["w_q"].to(x.dtype)
    k = kv_in @ p["w_k"].to(x.dtype)
    v = kv_in @ p["w_v"].to(x.dtype)
    if "b_q" in p:
        q = q + p["b_q"].to(x.dtype)
        k = k + p["b_k"].to(x.dtype)
        v = v + p["b_v"].to(x.dtype)
    q = split_heads(q, h, hd, hk) if pad else reshape(q, *x.shape[:-1], h,
                                                      hd)
    k = reshape(k, *kv_in.shape[:-1], hk, hd)
    v = reshape(v, *kv_in.shape[:-1], hk, hd)
    return q, k, v


def gqa_full(cfg: ModelConfig, p: dict, x: torch.Tensor, *, pos0: int = 0,
             window: int = 0, causal: bool = True,
             cross_kv: torch.Tensor | None = None, use_rope: bool = True,
             return_cache: bool = False):
    """Full-sequence attention through the flash-attention kernel.
    x: (B, S, D).  ``cross_kv`` (B, Sk, D), the encoder memory, makes it
    cross-attention: keys and values from it, no RoPE, no causal mask and
    no window.  With ``return_cache`` also returns (k, v), each
    (B, Hkv, Sk, hd), for the decode cache."""
    q, k, v = _qkv(cfg, p, x, cross_kv, pad=True)
    if use_rope and cross_kv is None:
        qpos = pos0 + torch.arange(x.shape[1], device=x.device)
        q = rope(q, qpos, theta=cfg.rope_theta, pct=cfg.rope_pct)
        k = rope(k, qpos, theta=cfg.rope_theta, pct=cfg.rope_pct)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)        # (B,Hkv,Sk,hd)
    out = ops.gqa_flash_attention(
        q.transpose(1, 2), kt, vt, window=window if cross_kv is None else 0,
        causal=causal and cross_kv is None)               # (B,H,S,hd)
    y = merge_heads(out.transpose(1, 2), cfg.n_heads, cfg.n_kv_heads) \
        @ p["w_o"].to(x.dtype)
    if return_cache:
        return y, (kt, vt)
    return y


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int,
                   window: int = 0, *, heads: int | None = None,
                   head_dim: int | None = None,
                   device: str | torch.device = "cuda"):
    """An empty GQA decode cache; ``heads`` and ``head_dim`` (the config's
    by default) are a device's shard's under a mesh."""
    hk = cfg.n_kv_heads if heads is None else heads
    hd = cfg.head_dim_ if head_dim is None else head_dim
    size = min(window, max_len) if window > 0 else max_len
    dt = cfg.activation_dtype
    return {
        "k": torch.zeros((batch, hk, size, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, hk, size, hd), dtype=dt, device=device),
        # per-lane ring map: slot -> absolute position (continuous batching:
        # every batch lane decodes at its own position)
        "slot_pos": torch.full((batch, size), -1, dtype=torch.int64,
                               device=device),
    }


def gqa_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
               pos: torch.Tensor, *, window: int = 0):
    """One-token decode. x: (B, 1, D); pos: (B,) per-lane positions.
    Writes this token's key and value into ``cache`` in place."""
    b = x.shape[0]
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v = _qkv(cfg, p, x)
    q = rope(q, pos[:, None], theta=cfg.rope_theta, pct=cfg.rope_pct)
    k = rope(k, pos[:, None], theta=cfg.rope_theta, pct=cfg.rope_pct)
    ck, cv, spos = cache["k"], cache["v"], cache["slot_pos"]
    size = ck.shape[2]
    slot = pos % size if window > 0 else torch.clamp(pos, max=size - 1)
    new = like_layout(ck, {0: 0, 1: 2, 3: 3})   # (B, 1, Hkv, hd)
    rows = like_layout(ck, {0: 0})
    if like_layout(spos, {0: 0}) == rows:
        on_local(_write_kv, (ck, cv, spos, k, v, pos, slot),
                 (None, None, None, new, new, rows, rows), None)
    else:
        # a slot map laid out apart from the cache's batch split (replicated,
        # as cache_pspecs lays it out): every device writes the whole map
        on_local(_write_kv, (ck, cv, None, k, v, None, slot),
                 (None, None, None, new, new, None, rows), None)
        whole = like_layout(spos, {0: 0})
        on_local(_write_slot_pos, (spos, pos, slot), (None, whole, whole),
                 None)

    scale = hd ** -0.5
    if not any(isinstance(pl, Shard) and pl.dim == 3
               for pl in getattr(ck, "placements", ())):
        # whole heads on each device (or a plain cache): all local
        heads = like_layout(ck, {0: 0, 1: 2})         # (B, 1, H, hd)
        out = on_local(
            lambda q_, ck_, cv_, sp, ps: _decode_mix(
                _decode_scores(q_, ck_, scale), cv_, sp, ps, window),
            (q, ck, cv, spos, pos), (heads, None, None, rows, rows), heads)
    else:
        # the head dim split over ``model`` (too few KV heads to split):
        # each device's scores are a partial sum, summed before the softmax
        split = like_layout(ck, {0: 0, 3: 3})
        part = on_local(lambda q_, ck_: _decode_scores(q_, ck_, scale),
                        (q, ck), (split, None),
                        [Partial() if isinstance(pl, Shard) and pl.dim == 3
                         else pl for pl in split])
        out = on_local(
            lambda s_, cv_, sp, ps: _decode_mix(s_, cv_, sp, ps, window),
            (part, cv, spos, pos),
            (like_layout(part, {0: 0}), None, rows, rows), split)
    out = reshape(out, b, 1, h * hd).to(x.dtype)
    return out @ p["w_o"].to(x.dtype), cache


def _decode_scores(q, ck, scale: float) -> torch.Tensor:
    """One query's scores against the cache: q (B, 1, H, hd), ck (B, Hkv,
    size, hd) -> (B, Hkv, H / Hkv, 1, size), float32, times ``scale``."""
    b, _, h, hd = q.shape
    hk = ck.shape[1]
    qh = q.reshape(b, 1, hk, h // hk, hd).permute(0, 2, 3, 1, 4)
    return torch.einsum("bkgqd,bksd->bkgqs", qh.to(torch.float32),
                        ck.to(torch.float32)) * scale


def _decode_mix(s_, cv, spos, pos, window: int) -> torch.Tensor:
    """The scores s_ (B, Hkv, G, 1, size) masked to the lanes' visible
    slots, softmaxed and applied to cv (B, Hkv, size, dv): (B, 1, H,
    dv), float32."""
    valid = spos >= 0                                  # (B, size)
    if window > 0:
        valid &= (pos[:, None] - spos) < window
    else:
        valid &= spos <= pos[:, None]
    s_ = torch.where(valid[:, None, None, None, :], s_, _NEG)
    pw = torch.softmax(s_, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", pw, cv.to(torch.float32))
    b, hk, g, _, dv = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, 1, hk * g, dv)


def _write_kv(ck, cv, spos, k, v, pos, slot) -> None:
    """This token's key and value into their cache slots, in place, and
    its position into the slot map spos (unless None): ck, cv (B, Hkv,
    size, hd), spos (B, size), k, v (B, 1, Hkv, hd), pos and slot (B,)."""
    lanes = torch.arange(ck.shape[0], device=ck.device)
    ck[lanes, :, slot, :] = k[:, 0].to(ck.dtype)
    cv[lanes, :, slot, :] = v[:, 0].to(cv.dtype)
    if spos is not None:
        spos[lanes, slot] = pos


def _write_slot_pos(spos, pos, slot) -> None:
    """Each lane's position into its slot of spos (B, size), in place."""
    spos[torch.arange(spos.shape[0], device=spos.device), slot] = pos


def gqa_decode_cross(cfg: ModelConfig, p: dict, x: torch.Tensor,
                     enc_out: torch.Tensor) -> torch.Tensor:
    """Cross-attention during decode: x (B, 1, D) against the static
    encoder memory ``enc_out`` (B, Sk, D), no cache update.  As in the
    reference it is ``gqa_full``: the kernel at Lq = 1, with K and V
    projected from ``enc_out`` again at every step."""
    return gqa_full(cfg, p, x, cross_kv=enc_out, causal=False,
                    use_rope=False)


# --- MLA (DeepSeek-V3) ---------------------------------------------------


def _mla_q(cfg: ModelConfig, p: dict, x: torch.Tensor,
           positions: torch.Tensor, *, pad: bool = False):
    m = cfg.mla
    h = cfg.n_heads
    cq = rms_norm(x @ p["w_dq"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = cq @ p["w_uq"].to(x.dtype)
    q = split_heads(q, h, m.qk_head_dim) if pad else reshape(
        q, *x.shape[:-1], h, m.qk_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = rope(q_rope, positions, theta=cfg.rope_theta)
    return q_nope, q_rope


def _mla_latent(cfg: ModelConfig, p: dict, x: torch.Tensor,
                positions: torch.Tensor):
    m = cfg.mla
    dkv = x @ p["w_dkv"].to(x.dtype)                   # (B,S,Rkv+rope)
    c_kv = rms_norm(dkv[..., :m.kv_lora_rank], p["kv_norm"], cfg.norm_eps)
    k_rope = dkv[..., m.kv_lora_rank:][:, :, None, :]  # (B,S,1,rope)
    k_rope = rope(k_rope, positions, theta=cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def mla_full(cfg: ModelConfig, p: dict, x: torch.Tensor, *, pos0: int = 0,
             return_cache: bool = False):
    """Full-sequence causal MLA through the flash-attention kernel, at q/k
    head dim ``qk_head_dim`` and v head dim ``v_head_dim``; the kernel's
    scale, q's head dim ** -0.5, is the reference's ``qk_head_dim **
    -0.5``.  x: (B, S, D).  With
    ``return_cache`` also returns the latent (B, S, kv_rank + rope_dim)
    for the decode cache."""
    m = cfg.mla
    h = cfg.n_heads
    b, s, _ = x.shape
    positions = pos0 + torch.arange(s, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, positions, pad=True)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    # q, k and v padded alike, one group: each head has its own K and V
    k_nope = split_heads(c_kv @ p["w_uk"].to(x.dtype), h,
                         m.qk_nope_head_dim)
    v = split_heads(c_kv @ p["w_uv"].to(x.dtype), h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, k_nope.shape[2], m.qk_rope_head_dim)], dim=-1)
    out = ops.gqa_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))   # (B,H,S,hdv)
    y = merge_heads(out.transpose(1, 2), h) @ p["w_o"].to(x.dtype)
    if return_cache:
        return y, torch.cat([c_kv, k_rope], dim=-1)    # (B,S,Rkv+rope)
    return y


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   dim: int | None = None,
                   device: str | torch.device = "cuda"):
    """An empty MLA decode cache; ``dim`` (the config's latent width by
    default) is a device's shard's under a mesh."""
    dim = cfg.mla.cache_dim if dim is None else dim
    return {"latent": torch.zeros((batch, max_len, dim),
                                  dtype=cfg.activation_dtype, device=device)}


def mla_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
               pos: torch.Tensor):
    """Absorbed-matrix MLA decode: attention runs entirely in latent
    space.  x: (B, 1, D); pos: (B,) per-lane positions.  Writes this
    token's latent into ``cache`` in place at ``pos``; a lane whose
    ``pos`` lies past the cache writes nothing there, as the reference's
    out-of-bounds scatter drops its update (the engine stops a request
    before its lane fills, but a free lane keeps counting)."""
    m = cfg.mla
    h = cfg.n_heads
    b = x.shape[0]
    q_nope, q_rope = _mla_q(cfg, p, x, pos[:, None])       # (B,1,H,*)
    c_kv, k_rope = _mla_latent(cfg, p, x, pos[:, None])
    new_lat = torch.cat([c_kv, k_rope], dim=-1)[:, 0]      # (B,D_lat)
    lat = cache["latent"]
    size = lat.shape[1]
    slot = torch.clamp(pos, max=size - 1)
    rows = like_layout(lat, {0: 0})
    on_local(_write_latent, (lat, new_lat, pos, slot),
             (None, like_layout(lat, {0: 0, 2: 1}), rows, rows), None)
    c_all, r_all = lat[..., :m.kv_lora_rank], lat[..., m.kv_lora_rank:]

    # absorb W_uk into the query:
    # q_eff[b,h,r] = sum_d q_nope[b,h,d] W_uk[r, h*d]
    wuk = reshape(p["w_uk"].to(x.dtype), m.kv_lora_rank, h,
                  m.qk_nope_head_dim)
    q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], wuk)
    scores = (torch.einsum("bhr,bsr->bhs", q_eff.to(torch.float32),
                           c_all.to(torch.float32))
              + torch.einsum("bhr,bsr->bhs", q_rope[:, 0].to(torch.float32),
                             r_all.to(torch.float32))) \
        * m.qk_head_dim ** -0.5
    valid = torch.arange(size, device=x.device)[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, :], scores, _NEG)
    pw = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhs,bsr->bhr", pw, c_all.to(torch.float32))
    wuv = reshape(p["w_uv"].to(x.dtype), m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", out_lat.to(x.dtype), wuv)
    y = reshape(out, b, 1, h * m.v_head_dim) @ p["w_o"].to(x.dtype)
    return y, cache


def _write_latent(lat, new_lat, pos, slot) -> None:
    """This token's latent into its cache slot, in place, where ``pos``
    lies inside the cache: lat (B, size, D_lat), new_lat (B, D_lat), pos
    and slot (B,)."""
    lanes = torch.arange(lat.shape[0], device=lat.device)
    lat[lanes, slot] = torch.where((pos < lat.shape[1])[:, None],
                                   new_lat.to(lat.dtype), lat[lanes, slot])
