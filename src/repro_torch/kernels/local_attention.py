"""Blocked causal / sliding-window flash attention on Hopper.

Used by every full-sequence attention of the LM stack
(``models.attention.gqa_full``: each prefill, and each training step,
forward and backward) and, in the reference, by the RecurrentGemma hybrid
blocks' local attention.
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

It takes what the reference's kernel takes: any head dim D from 1 up,
in float32, bfloat16 or float16 (computed in fp32, stored in q's dtype).
V may have fewer columns than q and k (Dv < D: MLA's 128 against 192),
which the reference's kernel does not take: its plain version takes Dv
as it is, and on the card the wrapper pads V with zero columns to D
before the launch and slices the output back to Dv after it (P·[V | 0]
= [P·V | 0] exactly), both as differentiable torch ops outside the
kernel's ``autograd.Function``, so the backward's dV for the padded
columns never reaches the caller.
Past D 256 the FMA kernels split D into chunks of 256 columns: the
scores sum over the chunks, and each output chunk is one CTA's, which
recomputes them (forward and backward alike).  It has two routes, chosen
by :func:`route` from the dtype and the head dim alone, never by a
failure: ``"tensor_core"`` for bfloat16 at head dims 64, 128, 192 and 256
(every attention of the serving and training paths: ``wgmma`` with
TMA-fed K/V tiles forward, ``mma.sync`` backward) and ``"fma"`` for every
other case (fp32 FMA, which the reference's f32 bound of 2e-5 needs; a D
that is not a power of two runs in the next bucket of 8, 16, 32, 64,
128, 192 or 256 columns with the padding masked, and a D past 256 in
chunks of 256).  TMA needs 16-byte
aligned base addresses: an operand of the tensor-core route that is not
aligned is copied to a fresh tensor and the same kernel runs on the copy,
counted in ``local_flash_attention.realigned``.  The source note says
what bounds each case on an H100 and what its design does about that.

The kernel is differentiable: when autograd needs a gradient of q, k or
v, the forward also writes each row's log-sum-exp and the backward is a
CUDA kernel too (three launches in one call: delta, dK/dV, dQ), behind a
``torch.autograd.Function``.  The reference has no backward kernel (it
trains through ``_sdpa_chunked``); the port trains through this one.
Without a gradient (serving) the forward writes no log-sum-exp.

Beside it sits its plain PyTorch version,
:func:`local_flash_attention_plain`: the dense masked softmax in fp32
that the reference's ``_sdpa_chunked`` computes, and its autograd is the
backward's plain version.  The wrapper takes it only for tensors on the
CPU; for CUDA tensors it launches the kernel or raises.  It counts its
forward launches in ``local_flash_attention.launches`` and its backward
calls in ``local_flash_attention.backward_launches``, and both again per
route in ``launches_by_route`` and ``backward_launches_by_route``; the
operands it copied to align them in ``realigned``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.common import charged

__all__ = ["local_flash_attention", "local_flash_attention_plain",
           "reset_launches", "route", "ROUTES"]

_NEG = -1.0e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_GRID_Y = 65535               # CUDA's limit on the (batch*head) axis
ROUTES = ("tensor_core", "fma")
_ROUTE_CODE = {"fma": 0, "tensor_core": 1}
_TC_HEAD_DIMS = (64, 128, 192, 256)   # head dims of the tensor-core route
_TMA_ALIGN = 16                   # bytes: TMA's base-address alignment


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel route for q, k and v of ``dtype`` at head dim ``d``:
    ``"tensor_core"`` for bfloat16 at 64, 128, 192 and 256, ``"fma"``
    otherwise."""
    if dtype == torch.bfloat16 and d in _TC_HEAD_DIMS:
        return "tensor_core"
    return "fma"


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
    lib.local_attention_forward.argtypes = [p] * 5 + [i] * 6 + [
        ctypes.c_float, i, i, i, p]
    lib.local_attention_forward.restype = i
    lib.local_attention_backward.argtypes = [p] * 10 + [i] * 6 + [
        ctypes.c_float, i, i, i, p]
    lib.local_attention_backward.restype = i
    lib.local_attention_encode_descriptors.argtypes = [p] * 3 + [i] * 6
    lib.local_attention_encode_descriptors.restype = i
    lib.local_attention_error_string.argtypes = [i]
    lib.local_attention_error_string.restype = ctypes.c_char_p
    return lib


def _on_cpu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """True when q, k and v all lie on the CPU, or all on the shape-only
    ``meta`` device (take the plain version), False when they lie on one
    CUDA device in a type and layout the kernel takes (launch it); raises
    on anything else."""
    devices = {t.device for t in (q, k, v)}
    if all(dv.type == "cpu" for dv in devices) or all(
            dv.type == "meta" for dv in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError("local_flash_attention: q, k and v must all lie on "
                         "the CPU or on one CUDA device, got "
                         f"{sorted(map(str, devices))}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("local_flash_attention: the CUDA kernel takes q, k "
                        "and v all float32, all bfloat16 or all float16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("local_flash_attention: the CUDA kernel takes "
                         "contiguous operands")
    return False


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` where TMA can read it (a 16-byte aligned base), else a copy at
    a fresh allocation, counted in ``realigned``; the copy is
    differentiable, so gradients reach ``t``."""
    if t.data_ptr() % _TMA_ALIGN == 0:
        return t
    local_flash_attention.realigned += 1
    return t.clone()


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.local_attention_error_string(code).decode()
        raise RuntimeError(f"local_flash_attention{what}: CUDA error "
                           f"{code}: {msg}")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             scale: float, window: int, causal: bool, kv_groups: int,
             with_lse: bool) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the forward kernel: (out, lse or None)."""
    bh, lq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((bh, lq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if bh == 0 or lq == 0:
        return out, lse
    lib = _lib()
    path = route(q.dtype, d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):   # the C entry launches on it
        code = lib.local_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _DTYPE_CODE[q.dtype],
            bh, lq, k.shape[1], d, kv_groups, scale, int(causal), window,
            _ROUTE_CODE[path], stream)
    _check(lib, code, "")
    local_flash_attention.launches += 1
    local_flash_attention.launches_by_route[path] += 1
    return out, lse


def _backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
              scale: float, window: int, causal: bool, kv_groups: int,
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on the forward's inputs, output and
    log-sum-exp and the output's gradient: (dq, dk, dv)."""
    bh, lq, d = q.shape
    dout = dout.to(q.dtype).contiguous()
    if dout.data_ptr() % _TMA_ALIGN:    # the kernels load 16-byte chunks
        dout = dout.clone()
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if bh == 0 or lq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((bh, lq), dtype=torch.float32, device=q.device)
    lib = _lib()
    path = route(q.dtype, d)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        code = lib.local_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPE_CODE[q.dtype], bh, lq, k.shape[1], d, kv_groups, scale,
            int(causal), window, _ROUTE_CODE[path], stream)
    _check(lib, code, " backward")
    local_flash_attention.backward_launches += 1
    local_flash_attention.backward_launches_by_route[path] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The kernel under autograd: the forward keeps its log-sum-exp, the
    backward is the CUDA backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, window, causal, kv_groups):
        out, lse = _forward(q, k, v, scale, window, causal, kv_groups,
                            with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, window, causal, kv_groups)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def _attention_work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    **_) -> dict[str, float]:
    """What the reference's model path counts for the same call: its dense
    chunked einsums (scores and output, masked and windowed positions
    included), 2·BH·Lq·Lk·(D + Dv) matmul FLOPs; and, by the port's rule
    for 'other' (views and broadcasts count nothing), the five
    elementwise passes over the scores around them (scale, mask, and the
    softmax's subtract, exp and divide) and the casts of operands that are
    not float32 to float32."""
    scores = math.prod(q.shape[:-1]) * k.shape[-2]     # BH·Lq·Lk
    other = 5.0 * scores
    if q.dtype != torch.float32:
        other += q.numel() + k.numel() + v.numel()
    return {"matmul": 2.0 * scores * (q.shape[-1] + v.shape[-1]),
            "other": other}


@charged(_attention_work)
def local_flash_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, scale: float | None = None,
                          window: int = 0, causal: bool = True,
                          kv_groups: int = 1) -> torch.Tensor:
    """Flash attention with optional sliding window.

    Args:
      q: (BH, Lq, D) — batch*query-heads flattened.
      k: (BHkv, Lk, D) with BHkv = BH // kv_groups (GQA: query head
        ``bh`` reads KV head ``bh // kv_groups``).
      v: (BHkv, Lk, Dv) with 1 <= Dv <= D; the output is (BH, Lq, Dv)
        (for Dv < D, on the card, a view of the padded launch's output).
      scale: the softmax scale, D ** -0.5 when None.
      window: 0 = unlimited; w > 0 = each query attends to at most the
        ``w`` most recent keys.
      causal: lower-triangular masking (assumes aligned q/k positions).

    The kernel picks its own tiles (32 to 128 queries by 32 or 64 keys,
    by route and head dim); unlike the reference's Pallas kernel it takes
    no block sizes.
    Gradients flow to q, k and v: through the CUDA backward on the card,
    through the plain version's autograd on the CPU.
    """
    if q.ndim != 3 or k.ndim != 3 or v.ndim != 3 \
            or v.shape[:2] != k.shape[:2] \
            or not 1 <= v.shape[2] <= k.shape[2]:
        raise ValueError("local_flash_attention: expected q (BH, Lq, D), "
                         "k (BHkv, Lk, D) and v (BHkv, Lk, Dv <= D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, lq, d = q.shape
    bhkv, lk, dk = k.shape
    dv = v.shape[2]
    if kv_groups < 1 or bh != bhkv * kv_groups or dk != d:
        raise ValueError(f"local_flash_attention: q {tuple(q.shape)} does "
                         f"not match k {tuple(k.shape)} at kv_groups "
                         f"{kv_groups}")
    if lk == 0 or d == 0:
        raise ValueError("local_flash_attention: no keys (Lk = 0) or no "
                         "head dim (D = 0)")
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
    if dv < d:
        # the kernel's V has q's D: zero columns in, their outputs out
        v = torch.nn.functional.pad(v, (0, d - dv))
        return _launch(q, k, v, scale, window, causal, kv_groups)[..., :dv]
    return _launch(q, k, v, scale, window, causal, kv_groups)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            window: int, causal: bool, kv_groups: int) -> torch.Tensor:
    """The kernel on CUDA operands of one head dim: under autograd when a
    gradient is needed, else the forward alone."""
    if route(q.dtype, q.shape[2]) == "tensor_core":
        q, k, v = (_aligned(t) for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, scale, window, causal,
                                     kv_groups)
    return _forward(q, k, v, scale, window, causal, kv_groups,
                    with_lse=False)[0]


def reset_launches() -> None:
    """Set the kernel's forward and backward launch counters, the totals
    and those per route, and the count of realigned operands to 0."""
    local_flash_attention.launches = 0
    local_flash_attention.realigned = 0
    local_flash_attention.backward_launches = 0
    local_flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
    local_flash_attention.backward_launches_by_route = dict.fromkeys(ROUTES,
                                                                     0)


reset_launches()
