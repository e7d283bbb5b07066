"""Mixture-of-Experts layer: shared + routed top-k, sort-based dispatch.

The twin of ``repro.models.moe``.  Tokens are routed *per batch row*:
each row's (S*k) assignments are sorted by expert, a slot's position
within its expert comes from the expert's segment start, and slots past
an expert's capacity C = ceil(S*k*cf / E) are dropped (standard
capacity-factor semantics: a dropped slot adds nothing, and its token
keeps the residual).  The gathered (B, E, C, D) activations go through
the three expert products batched over experts, as the reference's
``jnp.einsum``s (outside any kernel there too).  Under ``ep`` sharding
the gathered activations are constrained to (data, model, ., .), the
expert dim over ``model``, as in the reference: the identity off a mesh.

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

Under a mesh (DTensor activations) the routing is per row, as the
reference's is: the top-k selection, the dispatch indices, the gather of
each slot's token and the combine run on each device's own rows
(``distributed.sharding.on_local``, the batch dim's sharding kept and
every other dim replicated), since DTensor has no rule for ``sort``,
``searchsorted``, ``scatter`` or ``gather``.  The router's scores, when
their expert dim is split, and the experts' outputs, split over experts
(``ep``) or over each expert's width (``tp``), are gathered whole over
``model`` on the way in: the all-gathers a device's rows need, which the
dry run's count of collectives sees.  The three expert products stay
DTensor ops on the parameters' layouts.  A microbatch padded over the
data devices (``sharding.split_rows``) routes its pad rows among
themselves (capacity is per row); the load-balance loss takes its means
over the real rows only (``sharding.row_weights``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (constrain, like_layout,
                                              on_local, reshape, row_weights)
from repro_torch.models.config import ModelConfig

__all__ = ["moe_apply", "capacity"]


def capacity(cfg: ModelConfig, s: int) -> int:
    """Slots per expert and row for a row of ``s`` tokens: ceil(s * k *
    cf / E), in the reference's integer arithmetic (cf in quarters)."""
    m = cfg.moe
    e, k = m.n_routed, m.top_k
    return max(-(-s * k * int(4 * m.capacity_factor) // (4 * e)), 1)


def _top_k(scores: torch.Tensor, k: int):
    """The top k of each row of scores (B, S, E), lower expert first among
    equal scores (``jax.lax.top_k``), renormalized: (probs, idx)."""
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    return top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9), idx


def _router(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """x: (B, S, D) -> (probs (B,S,k), idx (B,S,k), aux_loss)."""
    m = cfg.moe
    logits = (x @ p["router"].to(x.dtype)).to(torch.float32)
    if cfg.name.startswith("deepseek"):
        scores = torch.sigmoid(logits)        # DeepSeek-V3 sigmoid router
    else:
        scores = torch.softmax(logits, dim=-1)
    rows = like_layout(scores, {0: 0})
    top, idx = on_local(functools.partial(_top_k, k=m.top_k), (scores,),
                        (rows,), (rows, rows))
    # Switch-style load-balance auxiliary loss
    e = m.n_routed
    experts = torch.arange(e, device=x.device)
    assign = (idx[..., None] == experts).to(torch.float32).sum(-2)  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    padded = row_weights()
    if padded is None:
        frac = assign.mean(dim=(0, 1)) / m.top_k
        prob = probs.mean(dim=(0, 1))
    else:               # a padded microbatch: the means over its real rows
        w, rows = padded
        n = rows * x.shape[1]
        frac = (assign * w[:, None, None]).sum(dim=(0, 1)) / n / m.top_k
        prob = (probs * w[:, None, None]).sum(dim=(0, 1)) / n
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

    top, idx, aux = _router(cfg, p, x)
    rows = like_layout(x, {0: 0})
    slot_tok, slot_w, slot_of = on_local(
        functools.partial(_dispatch, s=s, e=e, cap=cap), (idx, top),
        (rows, rows), (rows, rows, rows))
    gx = on_local(functools.partial(_gather_slots, e=e, cap=cap),
                  (x, slot_tok), (rows, rows), rows)       # (B,E,C,D)
    if m.shard_mode == "ep":
        gx = constrain(gx, ("pod", "data"), "model", None, None)

    w_in = p["we_in"].to(x.dtype)
    w_gate = p["we_gate"].to(x.dtype)
    w_out = p["we_out"].to(x.dtype)
    h = F.silu(torch.einsum("becd,edf->becf", gx, w_in))
    h = h * torch.einsum("becd,edf->becf", gx, w_gate)
    eo = torch.einsum("becf,efd->becd", h, w_out)          # (B,E,C,D)
    eo = reshape(eo, b, e * cap, d) * slot_w[..., None].to(x.dtype)
    out = on_local(_combine, (eo, slot_of, idx), (rows, rows, rows), rows)
    return out + _shared(p, x), aux


def _dispatch(idx: torch.Tensor, top: torch.Tensor, *, s: int, e: int,
              cap: int):
    """Each row's sort-based dispatch of its S*k (token, expert) slots.
    idx, top: (B, S, k).  Returns (the token of each (expert, capacity)
    slot, S for an empty one; its weight; the slot of each (token, j),
    E*C for a dropped one), the first two (B, E*C), the last (B, S, k)."""
    b, _, k = idx.shape
    dev = idx.device
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
    # the slot of each (token, j), E*C where dropped; the inverse of
    # ``order`` is a permutation, so no two writes meet
    slot_of = torch.empty_like(dest).scatter_(1, order, dest)   # (B, S*k)
    return slot_tok[:, :-1], slot_w[:, :-1], slot_of.reshape(b, s, k)


def _gather_slots(x: torch.Tensor, slot_tok: torch.Tensor, *, e: int,
                  cap: int) -> torch.Tensor:
    """The token of each slot, zeros for an empty one: (B, E, C, D)."""
    b, _, d = x.shape
    xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    gx = torch.gather(xp, 1, slot_tok[..., None].expand(b, e * cap, d))
    return gx.reshape(b, e, cap, d)


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
