"""Recurrent block families: RG-LRU (RecurrentGemma/Griffin) and xLSTM
(mLSTM matrix memory, sLSTM scalar memory).

Each function computes what its namesake in ``repro.models.recurrent``
does.  Full-sequence paths:

  * RG-LRU's recurrence h_t = a_t h_{t-1} + b_t is linear, so it runs as
    a log-depth scan over the sequence (:func:`associative_scan`): the
    same odd/even recursion as ``jax.lax.associative_scan``, each level
    one batched combine over every pair, so a 4096-token prefill takes
    2 log2(4096) levels of tensor ops, not 4096 steps, and does the
    reference's count of combines.
  * mLSTM and sLSTM loop over time, as the reference's ``lax.scan`` does
    (their gate stabilization is not associative); their states are
    O(d^2/head) and O(d).  The mLSTM state C is (B, H, dh, dh) in fp32:
    autograd keeps it for every step of a block, so training bounds it
    by checkpointing each block (``LM.loss``'s remat).  On the ``meta``
    device (the shape-only dry run) the loop is not walked: one step runs
    under ``core.profiler.repeated`` and stands for all of them, forward
    and backward (:func:`_time_loop`), so a 32k-token prefill counts as
    fast as a short one.

The reference's fp32 islands are kept: gates and states in fp32, ``m``
starting at -1e30, ``max(|n.q|, 1)``, and log sigmoid written
``-softplus(-f)``, with softplus as ``jax.nn.softplus`` computes it.
Every function also has a single-step decode form carrying its state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.profiler import repeated
from repro_torch.distributed.sharding import reshape
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import causal_conv1d

__all__ = ["rglru_full", "rglru_decode", "init_rglru_state",
           "mlstm_full", "mlstm_decode", "init_mlstm_state",
           "slstm_full", "slstm_decode", "init_slstm_state", "slstm_ffn",
           "associative_scan"]

_C_RGLRU = 8.0  # Griffin's fixed recurrence sharpness constant


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` (``logaddexp(x, 0)``) computes
    it: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


# --- RG-LRU ---------------------------------------------------------------------


def _combine(a1, b1, a2, b2):
    """The linear recurrence's composition: (a1, b1) then (a2, b2)."""
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along dim 1 (``even`` has as
    many elements as ``odd`` or one more)."""
    m = odd.shape[1]
    out = torch.stack([even[:, :m], odd], dim=2).flatten(1, 2)
    if even.shape[1] > m:
        out = torch.cat([out, even[:, m:]], dim=1)
    return out


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan of h_t = a_t h_{t-1} + b_t along dim 1:
    ``jax.lax.associative_scan(combine, (a, b), axis=1)`` by the same
    work-efficient recursion (combine adjacent pairs, scan the half, then
    fill in the even positions), so it does the reference's combines, in
    the reference's order.  Depth 2 log2(S); returns (prod a, h)."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def _rglru_gates(p: dict, u: torch.Tensor):
    """u: (..., W) conv output -> (a, beta-scaled input), both fp32."""
    r = torch.sigmoid((u @ p["w_a"].to(u.dtype)
                       + p["b_a"].to(u.dtype)).to(torch.float32))
    i = torch.sigmoid((u @ p["w_i"].to(u.dtype)
                       + p["b_i"].to(u.dtype)).to(torch.float32))
    log_a = -_C_RGLRU * _softplus(p["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    x_in = beta * (i * u.to(torch.float32))
    return a, x_in


def rglru_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
               conv_state: torch.Tensor | None = None,
               h0: torch.Tensor | None = None, *,
               return_state: bool = False):
    """Griffin recurrent block over a full sequence. x: (B, S, D)."""
    y = F.gelu(x @ p["w_y"].to(x.dtype), approximate="tanh")
    u, conv_out = causal_conv1d(x @ p["w_x"].to(x.dtype), p["conv_w"],
                                p["conv_b"], conv_state)
    a, x_in = _rglru_gates(p, u)
    if h0 is not None:
        # fold the carried state into step 0: b_0 <- a_0 h0 + b_0
        x_in = torch.cat([x_in[:, :1] + a[:, :1] * h0.to(
            torch.float32)[:, None], x_in[:, 1:]], dim=1)
    _, h = associative_scan(a, x_in)
    out = (h.to(x.dtype) * y) @ p["w_ro"].to(x.dtype)
    if return_state:
        return out, {"conv": conv_out, "h": h[:, -1, :].to(x.dtype)}
    return out


def init_rglru_state(cfg: ModelConfig, batch: int, *,
                     device: str | torch.device = "cuda") -> dict:
    w = cfg.lru_width or cfg.d_model
    dt = cfg.activation_dtype
    return {"conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dt,
                                device=device),
            "h": torch.zeros((batch, w), dtype=dt, device=device)}


def rglru_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict):
    """One step. x: (B, 1, D).  Returns (out, the new state)."""
    return rglru_full(cfg, p, x, conv_state=state["conv"], h0=state["h"],
                      return_state=True)


# --- loops over time ---------------------------------------------------------------


class _Repeated(torch.autograd.Function):
    """One step of a loop over time that stands for ``trips`` steps in a
    count: its forward and its backward both run under ``repeated``.
    The step's graph is built inside the forward, where no saved-tensor
    hooks of an enclosing checkpoint reach it, and differentiated in the
    backward, so no step (and no checkpointed region) is recomputed
    there."""

    @staticmethod
    def forward(ctx, step, trips, n_carry, n_x, *tensors):
        ins = [t.detach().requires_grad_(need) for t, need in
               zip(tensors, ctx.needs_input_grad[4:])]
        with torch.enable_grad(), repeated(trips), \
                torch.autograd.graph.saved_tensors_hooks(lambda t: t,
                                                         lambda t: t):
            carry, y = step(tuple(ins[:n_carry]),
                            tuple(ins[n_carry:n_carry + n_x]),
                            tuple(ins[n_carry + n_x:]))
        ctx.ins, ctx.outs, ctx.trips = ins, tuple(carry) + (y,), trips
        return tuple(o.detach() for o in ctx.outs)

    @staticmethod
    def backward(ctx, *gouts):
        pairs = [(o, g) for o, g in zip(ctx.outs, gouts)
                 if g is not None and o.requires_grad]
        want = [i for i in ctx.ins if i.requires_grad]
        got = iter([None] * len(want))
        if pairs and want:
            with repeated(ctx.trips):
                got = iter(torch.autograd.grad(
                    [o for o, _ in pairs], want, [g for _, g in pairs],
                    allow_unused=True))
        return (None,) * 4 + tuple(next(got) if i.requires_grad else None
                                   for i in ctx.ins)


def _time_loop(step, carry: tuple, xs: tuple, ws: tuple = ()):
    """``carry, y_t = step(carry, (x[:, t] for x in xs), ws)`` for every t
    of the sequence dim 1.  Returns (the last carry, the y_t stacked on
    dim 1).  On ``meta`` step 0 runs, then one step stands for the others
    (``_Repeated``) and its output is broadcast over time: the shapes, and
    the matmul counts under ``core.profiler``, of the walked loop."""
    s = xs[0].shape[1]
    if xs[0].device.type == "meta" and s > 2:
        # step 0 as it runs (its carry may need no gradient), then one
        # step standing for the s - 1 others
        carry, y0 = step(carry, tuple(x[:, 0] for x in xs), ws)
        outs = _Repeated.apply(step, s - 1, len(carry), len(xs), *carry,
                               *(x[:, 1] for x in xs), *ws)
        y = outs[-1].unsqueeze(1)
        return outs[:-1], torch.cat(
            [y0.unsqueeze(1), y.expand(y.shape[0], s - 1, *y.shape[2:])],
            dim=1)
    ys = []
    for t in range(s):
        carry, y = step(carry, tuple(x[:, t] for x in xs), ws)
        ys.append(y)
    return carry, torch.stack(ys, dim=1)


# --- mLSTM (xLSTM matrix memory) ---------------------------------------------------


def _mlstm_step(state, inp):
    """state: (C (B,H,dk,dv), n (B,H,dk), m (B,H)); one time step."""
    c, n, m = state
    q, k, v, i_pre, f_pre = inp             # (B,H,dk) x2, (B,H,dv), (B,H) x2
    log_f = -_softplus(-f_pre)              # log sigmoid(f)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = f_g[..., None, None] * c + i_g[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    denom = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)),
                        min=1.0)
    h = torch.einsum("bhkv,bhk->bhv", c, q) / denom[..., None]
    return (c, n, m_new), h


def _mlstm_qkvif(cfg: ModelConfig, p: dict, u: torch.Tensor,
                 v_src: torch.Tensor):
    b, s, di = u.shape
    h = cfg.n_heads
    dh = di // h
    q = reshape(u @ p["w_q"].to(u.dtype), b, s, h, dh)
    k = reshape(u @ p["w_k"].to(u.dtype), b, s, h, dh) * dh ** -0.5
    v = reshape(v_src @ p["w_v"].to(u.dtype), b, s, h, dh)
    i_pre = u @ p["w_if"].to(u.dtype) + p["b_if"].to(u.dtype)
    f_pre = u @ p["w_ff"].to(u.dtype) + p["b_ff"].to(u.dtype)
    f32 = torch.float32
    return (q.to(f32), k.to(f32), v.to(f32), i_pre.to(f32), f_pre.to(f32))


def _mlstm_out(p: dict, h_seq: torch.Tensor, u: torch.Tensor,
               gate: torch.Tensor, x_dtype: torch.dtype) -> torch.Tensor:
    b, s, nh, dh = h_seq.shape
    # per-head rms normalization (GroupNorm stand-in), then skip + output
    # gate
    flat = h_seq * torch.rsqrt(torch.mean(h_seq * h_seq, dim=-1,
                                          keepdim=True) + 1e-6)
    flat = reshape(flat, b, s, nh * dh).to(x_dtype)
    y = (flat + p["skip_scale"].to(x_dtype) * u) * F.silu(gate)
    return y @ p["w_down"].to(x_dtype)


def mlstm_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
               state: dict | None = None, *, return_state: bool = False):
    b, s, d = x.shape
    up = x @ p["w_up"].to(x.dtype)
    gate = x @ p["w_gate_up"].to(x.dtype)
    conv_state = state["conv"] if state is not None else None
    u, conv_out = causal_conv1d(up, p["conv_w"], p["conv_b"], conv_state)
    u = F.silu(u)
    q, k, v, i_pre, f_pre = _mlstm_qkvif(cfg, p, u, up)
    h = cfg.n_heads
    dh = (2 * d) // h
    if state is None:
        c = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, h, dh), dtype=torch.float32, device=x.device)
        m = torch.full((b, h), -1e30, dtype=torch.float32, device=x.device)
    else:
        c, n, m = state["c"], state["n"], state["m"]
    (c, n, m), hs = _time_loop(lambda st, xt, _: _mlstm_step(st, xt),
                               (c, n, m), (q, k, v, i_pre, f_pre))
    out = _mlstm_out(p, hs, u, gate, x.dtype)
    if return_state:
        return out, {"c": c, "n": n, "m": m, "conv": conv_out}
    return out


def init_mlstm_state(cfg: ModelConfig, batch: int, *,
                     device: str | torch.device = "cuda") -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    dh = (2 * d) // h
    f32 = torch.float32
    return {"c": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
            "m": torch.full((batch, h), -1e30, dtype=f32, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, 2 * d),
                                dtype=cfg.activation_dtype, device=device)}


def mlstm_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict):
    return mlstm_full(cfg, p, x, state, return_state=True)


# --- sLSTM (xLSTM scalar memory) ----------------------------------------------------


def _slstm_gates(cfg: ModelConfig, p: dict, xw: list[torch.Tensor],
                 h_prev: torch.Tensor) -> list[torch.Tensor]:
    """The four pre-activations (i, f, z, o) of one step, fp32: ``xw`` is
    the step's input projections x_t W_g, h_prev (B, D) the last output.
    The block-diagonal recurrence is one (dh, dh) matrix per head."""
    b, d = h_prev.shape
    nh = cfg.n_heads
    hh = reshape(h_prev, b, nh, d // nh)
    outs = []
    for g, xg in zip("ifzo", xw):
        rec = torch.einsum("bhk,hkj->bhj", hh, p[f"r_{g}"].to(xg.dtype))
        outs.append(xg + reshape(rec, b, d) + p[f"b_{g}"].to(xg.dtype))
    return [o.to(torch.float32) for o in outs]


def _slstm_step(cfg: ModelConfig, p: dict, state, xw):
    c, n, h, m = state
    i_pre, f_pre, z_pre, o_pre = _slstm_gates(cfg, p, xw,
                                              h.to(xw[0].dtype))
    log_f = -_softplus(-f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = f_g * c + i_g * torch.tanh(z_pre)
    n = f_g * n + i_g
    h_new = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1.0)
    return (c, n, h_new, m_new), h_new


def slstm_ffn(p: dict, y: torch.Tensor) -> torch.Tensor:
    """Post-recurrence gated FFN (projection factor 4/3); applied by the
    block."""
    return (F.silu(y @ p["ffn_in"].to(y.dtype))
            * (y @ p["ffn_gate"].to(y.dtype))) @ p["ffn_out"].to(y.dtype)


def slstm_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
               state: dict | None = None, *, return_state: bool = False):
    """Recurrence only — block wiring adds the residual + slstm_ffn.  The
    input projections x W_g of all steps are one product each, taken
    before the loop (the reference takes them step by step)."""
    b, s, d = x.shape
    if state is None:
        z = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        st = (z, z, z, torch.full((b, d), -1e30, dtype=torch.float32,
                                  device=x.device))
    else:
        st = (state["c"], state["n"], state["h"], state["m"])
    xw = tuple(x @ p[f"w_{g}"].to(x.dtype) for g in "ifzo")
    keys = [f"{w}_{g}" for w in "rb" for g in "ifzo"]   # what a step reads
    st, hs = _time_loop(
        lambda st_, xt, ws: _slstm_step(cfg, dict(zip(keys, ws)), st_,
                                        list(xt)),
        st, xw, tuple(p[k] for k in keys))
    out = hs.to(x.dtype)                              # (B,S,D)
    if return_state:
        c, n, h, m = st
        return out, {"c": c, "n": n, "h": h, "m": m}
    return out


def init_slstm_state(cfg: ModelConfig, batch: int, *,
                     device: str | torch.device = "cuda") -> dict:
    d = cfg.d_model
    f32 = torch.float32
    return {"c": torch.zeros((batch, d), dtype=f32, device=device),
            "n": torch.zeros((batch, d), dtype=f32, device=device),
            "h": torch.zeros((batch, d), dtype=f32, device=device),
            "m": torch.full((batch, d), -1e30, dtype=f32, device=device)}


def slstm_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, state: dict):
    return slstm_full(cfg, p, x, state, return_state=True)
