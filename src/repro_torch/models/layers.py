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


def _ce_chunk(xc: torch.Tensor, lc: torch.Tensor, hw: torch.Tensor,
              vocab: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of CE over valid positions, number of valid positions) of one
    sequence chunk: xc (B, sc, D), lc (B, sc)."""
    logits = (xc @ hw.T).to(torch.float32)               # (B, sc, Vp)
    col = torch.arange(hw.shape[0], device=xc.device)
    if hw.shape[0] != vocab:
        logits = torch.where(col < vocab, logits, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
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
