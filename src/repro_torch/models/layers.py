"""Shared neural-net layers (pure functions over parameter dictionaries).

Each function computes what its namesake in ``repro.models.layers`` does.
A matmul weight is taken in the activation dtype (``w.to(x.dtype)``), as
the reference casts it on every call; the port casts the weights once when
a model is loaded for serving (``repro_torch.models.params.
compute_params``), after which ``.to`` returns the tensor itself and
copies nothing; training keeps the float32 master weights and casts them
inside the graph on every call, so that the gradients land on them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ModelConfig

__all__ = ["rms_norm", "rope", "mlp_apply", "causal_conv1d",
           "embed_tokens", "chunked_ce_loss"]


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.to(torch.float32)).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, *,
         theta: float = 10_000.0, pct: float = 1.0) -> torch.Tensor:
    """Rotary embedding on the last dim. x: (..., S, H, hd); positions:
    (S,) or (B, S).

    ``pct`` < 1 rotates only the first ``pct * hd`` dims (StableLM-2
    partial rotary), as split halves (x1, x2) of the rotary slice.
    """
    hd = x.shape[-1]
    rot = int(hd * pct)
    rot -= rot % 2
    if rot == 0:
        return x
    half = rot // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=x.device) / half
    freqs = torch.pow(theta, exps)   # a host scalar: no copy, no sync
    ang = positions.to(torch.float32)[..., None] * freqs   # (S|B,S, half)
    if positions.ndim == 1:
        ang = ang[None, :, None, :]                         # (1,S,1,half)
    else:
        ang = ang[:, :, None, :]                            # (B,S,1,half)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:rot].to(torch.float32)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


def mlp_apply(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """Dense MLP: swiglu | geglu | relu2 (Nemotron squared-ReLU)."""
    up = x @ p["w_in"].to(x.dtype)
    if cfg.mlp_kind == "relu2":
        h = torch.square(torch.relu(up))
    elif cfg.mlp_kind == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh") * (x @ p["w_gate"].to(x.dtype))
    else:  # swiglu
        h = F.silu(up) * (x @ p["w_gate"].to(x.dtype))
    return h @ p["w_out"].to(x.dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal temporal conv. x: (B,S,C); w: (K,C); b: (C,).

    A sum of K shifted elementwise products, as the reference computes
    it.  ``state`` is the last K-1 inputs of the previous segment,
    (B, K-1, C) (zeros when None); returns (out, the new state), so that
    a prefill hands decode a warm buffer.
    """
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)                 # (B, S+K-1, C)
    s = x.shape[1]
    out = b.to(x.dtype)
    for j in range(k):
        out = out + xp[:, j:j + s, :] * w[j].to(x.dtype)
    return out, xp[:, xp.shape[1] - (k - 1):, :]


def embed_tokens(cfg: ModelConfig, embed: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``embed`` at ``tokens``, through ``F.embedding``, whose
    forward and backward DTensor also implements for a vocab-sharded
    table (under a mesh).  The cast copies even where the dtypes agree:
    a vocab-sharded lookup gives a masked partial sum, which the cast
    then reduces as an op of its own; left to a later redistribute, its
    backward would have to turn a partial-sum gradient back into the
    masked partial, which DTensor refuses."""
    return F.embedding(tokens, embed).to(cfg.activation_dtype, copy=True)


def _vocab_split(logits: torch.Tensor) -> list[int]:
    """The mesh dims of more than one device that split a DTensor's last
    dim (the vocab), where it holds no partial sum; [] otherwise (a plain
    tensor, an unsplit vocab, a (1, 1) mesh)."""
    if not isinstance(logits, DTensor) \
            or any(p.is_partial() for p in logits.placements):
        return []
    mesh, last = logits.device_mesh, logits.ndim - 1
    return [i for i, p in enumerate(logits.placements)
            if isinstance(p, Shard) and p.dim == last and mesh.size(i) > 1]


def _logsumexp(logits: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp`` over the last dim; over a vocab that a mesh
    splits, :class:`_VocabParallelLSE` on each device's shard."""
    dims = _vocab_split(logits)
    if not dims:
        return torch.logsumexp(logits, dim=-1)
    return _VocabParallelLSE.apply(logits, tuple(dims))


class _VocabParallelLSE(torch.autograd.Function):
    """The log-sum-exp over a vocab split across mesh dims, as XLA reduces
    the reference's ``jax.nn.logsumexp`` there: each device takes its
    shard's row max, all-reduces the max, takes its shard's sum of
    ``exp(x - max)``, all-reduces the sum, and sets ``lse = max +
    log(sum)``; the backward is ``exp(x - lse) * g`` on the shard, with no
    collective.  DTensor has no vocab-sharded rule for
    ``torch.logsumexp``: it gathers the logits whole.  The collectives are
    ``_c10d_functional`` ops, which ``core.profiler`` counts by kind.
    ``calls`` counts the forwards."""

    calls = 0

    @staticmethod
    def forward(ctx, logits, dims):
        import torch.distributed._functional_collectives as funcol
        _VocabParallelLSE.calls += 1
        mesh = logits.device_mesh
        x = logits.to_local()
        mx = x.amax(dim=-1)
        for i in dims:
            mx = funcol.all_reduce(mx, "max", (mesh, i))
        se = torch.exp(x - mx[..., None]).sum(dim=-1)
        for i in dims:
            se = funcol.all_reduce(se, "sum", (mesh, i))
        lse = mx + torch.log(se)
        ctx.save_for_backward(x, lse)
        ctx.mesh, ctx.in_pl = mesh, tuple(logits.placements)
        ctx.shape, ctx.stride = logits.shape, logits.stride()
        ctx.out_pl = [Replicate() if i in dims or (isinstance(p, Shard) and
                                                   p.dim == logits.ndim - 1)
                      else p for i, p in enumerate(logits.placements)]
        shape = logits.shape[:-1]
        return DTensor.from_local(lse, mesh, ctx.out_pl, run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        if list(g.placements) != ctx.out_pl:
            g = g.redistribute(ctx.mesh, ctx.out_pl)
        dx = torch.exp(x - lse[..., None]) * g.to_local()[..., None]
        return DTensor.from_local(dx, ctx.mesh, ctx.in_pl, run_check=False,
                                  shape=ctx.shape, stride=ctx.stride), None


def _ce_chunk(xc: torch.Tensor, lc: torch.Tensor, hw: torch.Tensor,
              vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of CE over valid positions, number of valid positions) of one
    sequence chunk: xc (B, sc, D), lc (B, sc).  Under a mesh that splits
    the vocab, the log-sum-exp runs on each device's shard
    (:class:`_VocabParallelLSE`)."""
    logits = (xc @ hw.T).to(torch.float32)               # (B, sc, Vp)
    col = torch.arange(hw.shape[0], device=xc.device)
    if hw.shape[0] != vocab:
        logits = torch.where(col < vocab, logits, -1e30)
    lse = _logsumexp(logits)
    # the label's logit by a masked sum over the vocab, as the reference
    # picks it: it also works on vocab-sharded logits (under a mesh), and
    # adds exact zeros
    lbl = torch.sum(torch.where(col == lc.clamp(min=0)[..., None], logits,
                                0.0), dim=-1)
    valid = (lc >= 0).to(torch.float32)
    return torch.sum((lse - lbl) * valid), torch.sum(valid)


def chunked_ce_loss(cfg: ModelConfig, head: torch.Tensor, x: torch.Tensor,
                    labels: torch.Tensor
                    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Cross-entropy with the vocab projection computed in sequence chunks.

    Never materializes the full (B, S, V) logits: each of
    ``cfg.logit_chunks`` chunks runs under ``torch.utils.checkpoint``, as
    the reference ``jax.checkpoint``s its scan body, so backward recomputes
    the chunk's (B, S/chunks, Vp) fp32 logits instead of saving them.
    Padded vocab columns are masked with -1e30; ``labels == -1`` means
    "ignore position".
    """
    b, s, _ = x.shape
    chunks = cfg.logit_chunks if s % cfg.logit_chunks == 0 else 1
    sc = s // chunks
    hw = head.to(cfg.activation_dtype)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(chunks):
        t, n = checkpoint(_ce_chunk, x[:, c * sc:(c + 1) * sc],
                          labels[:, c * sc:(c + 1) * sc], hw, cfg.vocab_size,
                          use_reentrant=False)
        tot = tot + t
        cnt = cnt + n
    loss = tot / torch.clamp(cnt, min=1.0)
    return loss, {"ce_sum": tot, "n_tokens": cnt}
