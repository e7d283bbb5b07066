"""Int8 error-feedback gradient compression for the cross-pod link.

The twin of the reference's ``repro.optim.compression``.  At 2+ pods the
gradient all-reduce crosses the slow inter-pod boundary — the
training-time analogue of the paper's conversion bottleneck.
Error-feedback quantization (Seide et al. 2014; Karimireddy et al. 2019)
cuts those bytes 4x against fp32 (2x against bf16) while the residual
state keeps the *long-run* gradient unbiased.

Usage across a process group of pods (``torch.distributed``):

    scale = ef_scale(g, res)                       # per-tensor fp32 scalars
    for s in leaves(scale): dist.all_reduce(s, MAX, group=pods)
    q, scale, res = ef_compress(g, res, scale=scale)
    wire = q.to(torch.int32); dist.all_reduce(wire, group=pods)
    g = ef_decompress(wire, scale) / n_pods

Sharing the quantization scale across the reducing group (the max, one
scalar collective per tensor) keeps every pod's dequantization exact for
what it sent, so the error-feedback guarantee holds across the link.
Rounding is half to even (``torch.round``, as ``jnp.round``), and a
scale is never below 1e-20 / 127.
"""

from __future__ import annotations

import torch

from repro_torch.models.params import map_tree

__all__ = ["ef_init", "ef_scale", "ef_compress", "ef_decompress"]

_QMAX = 127.0


def ef_init(grads):
    """Residual (error-feedback) state: one fp32 tensor per gradient."""
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def _scale_of(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.max(torch.abs(x)), min=1e-20) / _QMAX


def ef_scale(grads, residuals):
    """Per-tensor quantization scales (0-d fp32 tensors) for the
    feedback-corrected gradient.  Callers reducing across a group should
    take their max across it before passing them back via
    ``ef_compress(..., scale=)``, so that all participants quantize and
    dequantize on the same grid."""
    return map_tree(lambda g, r: _scale_of(g.to(torch.float32) + r),
                    grads, residuals)


def _compress_one(g: torch.Tensor, res: torch.Tensor,
                  scale: torch.Tensor | None):
    x = g.to(torch.float32) + res
    if scale is None:
        scale = _scale_of(x)
    q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX).to(torch.int8)
    new_res = x - q.to(torch.float32) * scale
    return q, scale, new_res


def ef_compress(grads, residuals, scale=None):
    """tree of grads -> (int8 tree, scale tree, new residual tree).

    ``scale``: an optional agreed scale tree (e.g. the max across the
    reducing group); defaults to each tensor's own scale."""
    if scale is None:
        flat = map_tree(lambda g, r: _compress_one(g, r, None), grads,
                        residuals)
    else:
        flat = map_tree(_compress_one, grads, residuals, scale)
    pick = lambda i: map_tree(lambda t: t[i], flat)
    return pick(0), pick(1), pick(2)


def ef_decompress(q_tree, scale_tree):
    return map_tree(lambda q, s: q.to(torch.float32) * s, q_tree,
                    scale_tree)
