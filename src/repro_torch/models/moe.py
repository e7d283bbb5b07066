"""Mixture-of-Experts layer: shared + routed top-k, sort-based dispatch.

The twin of ``repro.models.moe``.  Tokens are routed *per batch row*:
each row's (S*k) assignments are sorted by expert, a slot's position
within its expert comes from the expert's segment start, and slots past
an expert's capacity C = ceil(S*k*cf / E) are dropped (standard
capacity-factor semantics: a dropped slot adds nothing, and its token
keeps the residual).  The gathered (B, E, C, D) activations go through
the three expert products batched over experts, as the reference's
``jnp.einsum``s (outside any kernel there too).  The reference's sharding
constraint on the gathered activations is identity off a mesh and is
left out.

Every shape depends on the config and the input's shape only (no
``nonzero``, no ``.item()``), so a count on the ``meta`` device sees the
layer as any device runs it.  Three points where torch's primitives
differ from jax's:

* top-k is read off a stable descending sort: ``jax.lax.top_k`` puts the
  lower expert first among equal scores, and the router's logits are
  formed in the activation dtype (bf16 at full size), so exact ties among
  60 or 256 experts do happen; ``torch.topk`` promises no order for them;
* the reference combines with a scatter-add over (row, token), which
  adds a token's k expert outputs in slot order, i.e. by ascending
  expert.  On CUDA, ``index_add_`` / ``scatter_add_`` use atomics, whose
  order (and so a bf16 sum) changes from run to run; here each (token,
  j) gathers its slot's output (0 when dropped) and the k terms are
  summed in ascending expert order, the reference's order, the same bits
  on every run;
* the sort and ``searchsorted`` are the stable and left-sided ones the
  reference calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

__all__ = ["moe_apply", "capacity"]


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert and row for a row of ``s`` tokens: ceil(s * k *
    cf / E), in the reference's integer arithmetic (cf in quarters)."""
    m = cfg.moe
    e, k = m.n_routed, m.top_k
    return max(-(-s * k * int(4 * m.capacity_factor) // (4 * e)), 1)


def _router(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B, S, D) -> (probs (B,S,k), idx (B,S,k), aux_loss)."""
    m = cfg.moe
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    if cfg.name.startswith("deepseek"):
        scores = torch.sigmoid(logits)        # DeepSeek-V3 sigmoid router
    else:
        scores = torch.softmax(logits, dim=-1)
    # the top k, lower expert first among equal scores (jax.lax.top_k)
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[..., :m.top_k], idx[..., :m.top_k]
    top = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance auxiliary loss
    e = m.n_routed
    experts = torch.arange(e, device=x.device)
    assign = (idx[..., None] == experts).to(torch.float32).sum(-2)  # (B,S,E)
    frac = assign.mean(dim=(0, 1)) / m.top_k
    prob = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    aux = m.aux_loss_coef * e * torch.sum(frac * prob)
    return top, idx, aux


def _shared(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "ws_in" not in p:
        return torch.zeros_like(x)
    h = F.silu(x @ p["ws_in"].to(x.dtype)) * (x @ p["ws_gate"].to(x.dtype))
    return h @ p["ws_out"].to(x.dtype)


def moe_apply(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.n_routed, m.top_k
    cap = capacity(cfg, s)
    dev = x.device

    top, idx, aux = _router(cfg, p, x)

    # ---- build per-row dispatch (all along the row's own S*k slots) -------
    flat_e = idx.reshape(b, s * k)                        # expert of each slot
    flat_t = torch.arange(s, device=dev).repeat_interleave(k).expand(b, -1)
    flat_p = top.reshape(b, s * k)

    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, -1, order)
    st = torch.gather(flat_t, -1, order)
    sp = torch.gather(flat_p, -1, order)
    # position within expert segment
    starts = torch.searchsorted(
        se, torch.arange(e, device=dev).expand(b, -1).contiguous(),
        right=False)
    pos_in_e = torch.arange(s * k, device=dev) - torch.gather(starts, -1, se)
    keep = pos_in_e < cap
    dest = torch.where(keep, se * cap + pos_in_e, e * cap)  # overflow: E*C

    # token and weight of each (expert, capacity) slot; S = padding token.
    # Dropped slots all write the overflow slot (the same values), which is
    # sliced off.
    slot_tok = torch.full((b, e * cap + 1), s, dtype=torch.int64, device=dev)
    slot_w = torch.zeros((b, e * cap + 1), dtype=torch.float32, device=dev)
    slot_tok.scatter_(1, dest, torch.where(keep, st, s))
    slot_w.scatter_(1, dest, torch.where(keep, sp, 0.0))
    slot_tok, slot_w = slot_tok[:, :-1], slot_w[:, :-1]

    # ---- gather -> expert compute -> combine ------------------------------
    xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    gx = torch.gather(xp, 1, slot_tok[..., None].expand(b, e * cap, d))
    gx = gx.reshape(b, e, cap, d)

    w_in = p["we_in"].to(x.dtype)
    w_gate = p["we_gate"].to(x.dtype)
    w_out = p["we_out"].to(x.dtype)
    h = F.silu(torch.einsum("becd,edf->becf", gx, w_in))
    h = h * torch.einsum("becd,edf->becf", gx, w_gate)
    eo = torch.einsum("becf,efd->becd", h, w_out)          # (B,E,C,D)
    eo = eo.reshape(b, e * cap, d) * slot_w[..., None].to(x.dtype)

    # the slot of each (token, j), E*C where dropped; the inverse of
    # ``order`` is a permutation, so no two writes meet
    slot_of = torch.empty_like(dest).scatter_(1, order, dest)   # (B, S*k)
    out = _combine(eo, slot_of.reshape(b, s, k), idx)
    return out + _shared(p, x), aux


def _combine(eo: torch.Tensor, slot_of: torch.Tensor,
             idx: torch.Tensor) -> torch.Tensor:
    """Each token's k expert outputs summed, without atomics.  eo: (B, E*C,
    D) weighted slot outputs; slot_of: (B, S, k) the slot of each (token,
    j), E*C for a dropped one (which reads a zero row); idx: (B, S, k) its
    expert.  The k terms are added one by one in ascending expert order,
    as the reference's scatter-add adds them (a token's top-k experts are
    distinct), so a low-precision sum has the reference's bits on every
    call.  Returns (B, S, D)."""
    b, s, k = idx.shape
    d = eo.shape[-1]
    eo = torch.cat([eo, eo.new_zeros((b, 1, d))], dim=1)
    by_expert = torch.gather(slot_of, 2, torch.argsort(idx, dim=-1))
    per_j = torch.gather(eo, 1, by_expert.reshape(b, s * k, 1).expand(
        b, s * k, d)).reshape(b, s, k, d)
    out = per_j[:, :, 0]
    for j in range(1, k):
        out = out + per_j[:, :, j]
    return out
