"""Shared neural-net layers (pure functions over parameter dictionaries).

Each function computes what its namesake in ``repro.models.layers`` does.
A matmul weight is taken in the activation dtype (``w.to(x.dtype)``), as
the reference casts it on every call; the port casts the weights once when
a model is loaded (``repro_torch.models.params.compute_params``), after
which ``.to`` returns the tensor itself and copies nothing.
``chunked_ce_loss`` and ``causal_conv1d`` wait for the training and
recurrent slices.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

__all__ = ["rms_norm", "rope", "mlp_apply", "embed_tokens"]


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


def embed_tokens(cfg: ModelConfig, embed: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    return embed[tokens].to(cfg.activation_dtype)
