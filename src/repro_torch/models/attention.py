"""Attention: GQA (optional sliding window / bias / partial rotary), with
full-sequence and single-token-decode paths.

Full-sequence attention (``gqa_full``, every prefill) goes through the
hand-written CUDA flash-attention kernel (``kernels.ops.
gqa_flash_attention``) where the reference runs its chunked jnp path
(``_sdpa_chunked``); query and key positions line up there, which is what
the kernel's causal mask assumes.  ``_sdpa_chunked`` stays here as the
plain version, in the reference's (B, S, H, hd) layout.  Decode
(``gqa_decode``, one query against the cache) has no kernel in the
reference either and stays plain tensor code.  MLA waits for its slice.

Decode caches: k/v (B, Hkv, S_max, hd), written at ``pos`` per step.
Windowed layers use a ring buffer of size ``window`` plus a slot->absolute
position buffer, so a long stream needs O(window) memory.  Unlike the
reference, whose arrays are immutable, ``gqa_decode`` writes the new key
and value into the cache in place and returns the same tensors: a copy of
every layer's cache per token is what that saves.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.local_attention import local_flash_attention_plain
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rope

__all__ = ["gqa_full", "gqa_decode", "init_gqa_cache"]

_NEG = -1.0e30


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int) -> torch.Tensor:
    """q: (B,S,H,hd); k/v: (B,Sk,Hkv,hd), positions aligned at 0.  Returns
    (B,S,H,hd): the plain version of what ``gqa_full`` sends to the
    kernel."""
    b, s, h, hd = q.shape
    _, sk, hkv, _ = k.shape
    out = local_flash_attention_plain(
        q.transpose(1, 2).reshape(b * h, s, hd),
        k.transpose(1, 2).reshape(b * hkv, sk, hd),
        v.transpose(1, 2).reshape(b * hkv, sk, v.shape[-1]),
        window=window, causal=causal, kv_groups=h // hkv)
    return out.reshape(b, h, s, -1).transpose(1, 2)


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = x @ p["w_q"].to(x.dtype)
    k = x @ p["w_k"].to(x.dtype)
    v = x @ p["w_v"].to(x.dtype)
    if "b_q" in p:
        q = q + p["b_q"].to(x.dtype)
        k = k + p["b_k"].to(x.dtype)
        v = v + p["b_v"].to(x.dtype)
    q = q.reshape(*x.shape[:-1], h, hd)
    k = k.reshape(*x.shape[:-1], hk, hd)
    v = v.reshape(*x.shape[:-1], hk, hd)
    return q, k, v


def gqa_full(cfg: ModelConfig, p: dict, x: torch.Tensor, *, pos0: int = 0,
             window: int = 0, causal: bool = True,
             return_cache: bool = False):
    """Full-sequence self-attention through the flash-attention kernel.
    x: (B, S, D).  With ``return_cache`` also returns (k, v), each
    (B, Hkv, S, hd), for the decode cache."""
    q, k, v = _qkv(cfg, p, x)
    qpos = pos0 + torch.arange(x.shape[1], device=x.device)
    q = rope(q, qpos, theta=cfg.rope_theta, pct=cfg.rope_pct)
    k = rope(k, qpos, theta=cfg.rope_theta, pct=cfg.rope_pct)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)        # (B,Hkv,S,hd)
    out = ops.gqa_flash_attention(q.transpose(1, 2), kt, vt, window=window,
                                  causal=causal)          # (B,H,S,hd)
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
