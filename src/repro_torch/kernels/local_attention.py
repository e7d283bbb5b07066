"""Blocked causal / sliding-window flash attention on Hopper.

Used by every prefill of the LM stack (``models.attention.gqa_full``) and,
in the reference, by the RecurrentGemma hybrid blocks' local attention.
The kernel is hand-written CUDA for ``sm_90a``
(``repro_torch/csrc/local_attention.cu``, built by
:mod:`repro_torch.kernels.build` and called through ``ctypes``).  It
replaces the Pallas TPU kernel ``_attn_kernel`` of
``src/repro/kernels/local_attention.py``: an online softmax over key tiles
with fp32 accumulator, max and sum, masks of -1e30, GQA through
``bh // kv_groups`` with no copies, and the output in q's dtype.  It
skips tiles that are fully masked, which the reference runs; skipping is
exact.  Ragged lengths are masked inside the kernel, so any Lq and Lk
work (the reference's ``pick_block`` falls back to one whole-axis block).
The source note says what bounds it on an H100 and what its design does
about that.

Beside it sits its plain PyTorch version,
:func:`local_flash_attention_plain`: the dense masked softmax in fp32
that the reference's ``_sdpa_chunked`` computes.  The wrapper takes it
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises.  It counts its launches in ``local_flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["local_flash_attention", "local_flash_attention_plain",
           "reset_launches", "HEAD_DIMS"]

_NEG = -1.0e30
HEAD_DIMS = (8, 16, 32, 64, 128)  # head dims the kernel is built for
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535               # CUDA's limit on the (batch*head) axis


def _mask(lq: int, lk: int, causal: bool, window: int,
          device: torch.device) -> torch.Tensor:
    qi = torch.arange(lq, device=device)[:, None]
    ki = torch.arange(lk, device=device)[None, :]
    m = torch.ones((lq, lk), dtype=torch.bool, device=device)
    if causal:
        m &= qi >= ki
    if window > 0:
        m &= (qi - ki) < window
    return m


def local_flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *,
                                scale: float | None = None, window: int = 0,
                                causal: bool = True,
                                kv_groups: int = 1) -> torch.Tensor:
    """Dense masked softmax attention in fp32, (BH, Lq, D) x (BHkv, Lk, D).

    The query heads of one KV head are a view, not a copy
    (``(BHkv, g, Lq, D)``); the result is in q's dtype.  Wherever a query
    sees at least one key — every row of a prefill — this is what the
    reference's ``_sdpa_chunked`` computes; a row that sees none is 0, as
    in the reference's Pallas kernel.
    """
    bh, lq, d = q.shape
    bhkv, lk, _ = k.shape
    if scale is None:
        scale = d ** -0.5
    qg = q.reshape(bhkv, kv_groups, lq, d).to(torch.float32)
    s = torch.einsum("bgqd,bkd->bgqk", qg, k.to(torch.float32)) * scale
    mask = _mask(lq, lk, causal, window, q.device)
    s = torch.where(mask, s, _NEG)
    # where(mask, p, 0), as the kernel has it: a row that sees no key at
    # all (a window past the last key) comes out 0, not a uniform average
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    out = torch.einsum("bgqk,bkd->bgqd", p, v.to(torch.float32))
    return out.reshape(bh, lq, v.shape[-1]).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, built on first use, with every argument typed
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    from repro_torch.kernels.build import library
    lib = library("local_attention")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.local_attention_forward.argtypes = [p, p, p, p, i, i, i, i, i, i,
                                            ctypes.c_float, i, i, p]
    lib.local_attention_forward.restype = i
    lib.local_attention_error_string.argtypes = [i]
    lib.local_attention_error_string.restype = ctypes.c_char_p
    return lib


def _on_cpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """True when q, k and v all lie on the CPU (take the plain version),
    False when they lie on one CUDA device in a type and layout the
    kernel takes (launch it); raises on anything else."""
    devices = {t.device for t in (q, k, v)}
    if all(dv.type == "cpu" for dv in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError("local_flash_attention: q, k and v must all lie on "
                         "the CPU or on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("local_flash_attention: the CUDA kernel takes q, k "
                        "and v all float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("local_flash_attention: the CUDA kernel takes "
                         "contiguous operands")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"local_flash_attention: the CUDA kernel takes "
                         f"head dims {HEAD_DIMS}, got {q.shape[-1]}")
    return False


def local_flash_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, scale: float | None = None,
                          window: int = 0, causal: bool = True,
                          kv_groups: int = 1) -> torch.Tensor:
    """Flash attention with optional sliding window.

    Args:
      q: (BH, Lq, D) — batch*query-heads flattened.
      k, v: (BHkv, Lk, D) with BHkv = BH // kv_groups (GQA: query head
        ``bh`` reads KV head ``bh // kv_groups``).
      window: 0 = unlimited; w > 0 = each query attends to at most the
        ``w`` most recent keys.
      causal: lower-triangular masking (assumes aligned q/k positions).

    The kernel tiles by 64 queries x 64 keys; unlike the reference's Pallas
    kernel it takes no block sizes.
    """
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError("local_flash_attention: expected q (BH, Lq, D) and "
                         f"k, v (BHkv, Lk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, lq, d = q.shape
    bhkv, lk, dk = k.shape
    if kv_groups < 1 or bh != bhkv * kv_groups or dk != d:
        raise ValueError(f"local_flash_attention: q {tuple(q.shape)} does "
                         f"not match k {tuple(k.shape)} at kv_groups "
                         f"{kv_groups}")
    if lk == 0:
        raise ValueError("local_flash_attention: no keys (Lk = 0)")
    if window < 0:
        raise ValueError("local_flash_attention: window must be >= 0")
    if scale is None:
        scale = d ** -0.5
    if _on_cpu(q, k, v):
        return local_flash_attention_plain(q, k, v, scale=scale,
                                           window=window, causal=causal,
                                           kv_groups=kv_groups)
    if bh > _MAX_GRID_Y:
        raise ValueError(f"local_flash_attention: BH {bh} exceeds "
                         f"{_MAX_GRID_Y}")
    out = torch.empty_like(q)
    if bh == 0 or lq == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):   # the C entry launches on it
        code = lib.local_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], bh, lq, lk, d, kv_groups, scale,
            int(causal), window, stream)
    if code != 0:
        msg = lib.local_attention_error_string(code).decode()
        raise RuntimeError(f"local_flash_attention: CUDA error {code}: "
                           f"{msg}")
    local_flash_attention.launches += 1
    return out


local_flash_attention.launches = 0


def reset_launches() -> None:
    """Set the kernel's launch counter to 0."""
    local_flash_attention.launches = 0
