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
"""

from __future__ import annotations

import torch

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
         kv_x: torch.Tensor | None = None):
    """q from ``x``; k and v from ``kv_x`` (cross-attention's encoder
    memory), or from ``x`` when None."""
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    kv_in = x if kv_x is None else kv_x
    q = x @ p["w_q"].to(x.dtype)
    k = kv_in @ p["w_k"].to(x.dtype)
    v = kv_in @ p["w_v"].to(x.dtype)
    if "b_q" in p:
        q = q + p["b_q"].to(x.dtype)
        k = k + p["b_k"].to(x.dtype)
        v = v + p["b_v"].to(x.dtype)
    q = q.reshape(*x.shape[:-1], h, hd)
    k = k.reshape(*kv_in.shape[:-1], hk, hd)
    v = v.reshape(*kv_in.shape[:-1], hk, hd)
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
    q, k, v = _qkv(cfg, p, x, cross_kv)
    if use_rope and cross_kv is None:
        qpos = pos0 + torch.arange(x.shape[1], device=x.device)
        q = rope(q, qpos, theta=cfg.rope_theta, pct=cfg.rope_pct)
        k = rope(k, qpos, theta=cfg.rope_theta, pct=cfg.rope_pct)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)        # (B,Hkv,Sk,hd)
    out = ops.gqa_flash_attention(
        q.transpose(1, 2), kt, vt, window=window if cross_kv is None else 0,
        causal=causal and cross_kv is None)               # (B,H,S,hd)
    y = out.transpose(1, 2).reshape(*x.shape[:-1], -1) @ p["w_o"].to(x.dtype)
    if return_cache:
        return y, (kt, vt)
    return y


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int,
                   window: int = 0, *, device: str | torch.device = "cuda"):
    hk, hd = cfg.n_kv_heads, cfg.head_dim_
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
    lanes = torch.arange(b, device=x.device)
    ck[lanes, :, slot, :] = k[:, 0].to(ck.dtype)
    cv[lanes, :, slot, :] = v[:, 0].to(cv.dtype)
    spos[lanes, slot] = pos

    qh = q.reshape(b, 1, hk, h // hk, hd).permute(0, 2, 3, 1, 4)
    s_ = torch.einsum("bkgqd,bksd->bkgqs", qh.to(torch.float32),
                      ck.to(torch.float32)) * hd ** -0.5
    valid = spos >= 0                                  # (B, size)
    if window > 0:
        valid &= (pos[:, None] - spos) < window
    else:
        valid &= spos <= pos[:, None]
    s_ = torch.where(valid[:, None, None, None, :], s_, _NEG)
    pw = torch.softmax(s_, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", pw, cv.to(torch.float32))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h * hd).to(x.dtype)
    return out @ p["w_o"].to(x.dtype), cache


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
           positions: torch.Tensor):
    m = cfg.mla
    h = cfg.n_heads
    cq = rms_norm(x @ p["w_dq"].to(x.dtype), p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"].to(x.dtype)).reshape(*x.shape[:-1], h,
                                             m.qk_head_dim)
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
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    c_kv, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = (c_kv @ p["w_uk"].to(x.dtype)).reshape(b, s, h,
                                                    m.qk_nope_head_dim)
    v = (c_kv @ p["w_uv"].to(x.dtype)).reshape(b, s, h, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_head_dim)], dim=-1)
    out = ops.gqa_flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2))   # (B,H,S,hdv)
    y = out.transpose(1, 2).reshape(b, s, -1) @ p["w_o"].to(x.dtype)
    if return_cache:
        return y, torch.cat([c_kv, k_rope], dim=-1)    # (B,S,Rkv+rope)
    return y


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                   device: str | torch.device = "cuda"):
    return {"latent": torch.zeros((batch, max_len, cfg.mla.cache_dim),
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
    lanes = torch.arange(b, device=x.device)
    slot = torch.clamp(pos, max=size - 1)
    lat[lanes, slot] = torch.where((pos < size)[:, None],
                                   new_lat.to(lat.dtype), lat[lanes, slot])
    c_all, r_all = lat[..., :m.kv_lora_rank], lat[..., m.kv_lora_rank:]

    # absorb W_uk into the query:
    # q_eff[b,h,r] = sum_d q_nope[b,h,d] W_uk[r, h*d]
    wuk = p["w_uk"].to(x.dtype).reshape(m.kv_lora_rank, h,
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
    wuv = p["w_uv"].to(x.dtype).reshape(m.kv_lora_rank, h, m.v_head_dim)
    out = torch.einsum("bhr,rhd->bhd", out_lat.to(x.dtype), wuv)
    y = out.reshape(b, 1, h * m.v_head_dim) @ p["w_o"].to(x.dtype)
    return y, cache
