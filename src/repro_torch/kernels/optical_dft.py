"""Fused 4f-optics DFT pipeline (DFT-as-matmul + DAC + detector) on Hopper.

The paper's accelerator computes a 2-D Fourier transform by free-space
diffraction.  Its digital twin is the matmul form of the DFT:

    F = W_h @ A @ W_w^T,   W_n[j, k] = exp(-2 pi i j k / n) / sqrt(n)

carried as separate (re, im) planes, in two stages with the physics fused
in:

  stage 1 (``dft_stage1_batched``):  T[b] = W_h @ quantize_dac(A[b])
  stage 2 (``dft_stage2_batched``):  I[b] = |T[b] @ W_w^T|^2   (detector)

Each stage is a hand-written CUDA kernel for ``sm_90a``
(``repro_torch/csrc/optical_dft.cu``, built by
:mod:`repro_torch.kernels.build` and called through ``ctypes``).  They
replace the Pallas TPU kernels ``_stage1_batched_kernel`` and
``_stage2_batched_kernel`` of ``src/repro/kernels/optical_dft.py``.  The
source note in the ``.cu`` file says what bounds them on an H100
(operations) and what their design does about it.

Each stage has two routes, chosen by :func:`route` from the shapes, the
operands' alignment and the DAC's bits alone, never by a failure:
``"tensor_core"`` (3xTF32 on ``wgmma``, TMA-fed, the contraction split
across a thread-block cluster of :func:`tc_split` CTAs) when k and n are
multiples of 4, every operand is 16-byte aligned and the DAC has fewer
than 24 bits — every 512x512 launch of the offload and serving paths —
and ``"fma"`` (fp32 FMA on the CUDA cores) otherwise.  A failed launch
raises; nothing falls back to the other route.

Beside each kernel sits its plain PyTorch version (``*_plain``):
``torch.matmul`` on the (re, im) planes in fp32 with the same DAC and
detector.  A wrapper takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises — there is no fallback.
Each wrapper counts its launches in a plain integer attribute
(``dft_stage1_batched.launches``) and again per route in
``launches_by_route``, so a run can show that its main path went through
the kernels and on which route.

The wrappers keep the reference's block-plan arguments (``bb/bm/bk/bn``)
for parity; they are validated and not used.  The plan is sized for a
TPU's VMEM, and tiling by it would make a frame's bits depend on the
runtime's memory budget: the kernels' tiles and split depend on
``(m, k, n)`` alone, so frame i of a batched call is bit-equal to the
single-frame call on either route.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels.common import charged

__all__ = [
    "dft_matrix_factors",
    "dft_stage1",
    "dft_stage2",
    "dft_stage1_batched",
    "dft_stage2_batched",
    "dft_stage1_batched_plain",
    "dft_stage2_batched_plain",
    "optical_dft2_intensity",
    "optical_dft2_intensity_batched",
    "reset_launches",
    "route",
    "tc_split",
    "ROUTES",
]

_MAX_GRID_Z = 65535  # CUDA's limit on the batch axis of the launch grid
ROUTES = ("tensor_core", "fma")
_ROUTE_CODE = {"fma": 0, "tensor_core": 1}
_TMA_ALIGN = 16      # bytes: TMA's base-address and row-stride alignment
# the tensor-core route's tile (csrc/optical_dft.cu: TC_BM, TC_BN, TC_BK)
TC_ROWS, TC_W_ROWS, TC_STEP = 128, 64, 32
# CTAs one frame may fill on the tensor-core route: half of an H100's 132
# SMs (see tc_split)
_FRAME_CTAS = 66
# the tensor-core route's DAC divides by a corrected reciprocal, exact
# below 2^23 levels; more bits take the FMA route, which divides
_TC_MAX_DAC_BITS = 23


def dft_matrix_factors(n: int, dtype: torch.dtype = torch.float32,
                       device: torch.device | str | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(re, im) of the unitary DFT matrix W_n.

    The phase is reduced exactly, ``(j * k) mod n`` in integers, and the
    angle and its cosine/sine are taken in float64 before the cast, so
    the factors are as accurate as float32 can hold at every n (the fft2
    oracle is what they are held to).
    """
    j = torch.arange(n, dtype=torch.int64)
    r = torch.outer(j, j) % n
    ang = r.to(torch.float64) * (-2.0 * math.pi / n)
    scale = 1.0 / math.sqrt(n)
    wr = (torch.cos(ang) * scale).to(dtype)
    wi = (torch.sin(ang) * scale).to(dtype)
    return wr.to(device), wi.to(device)


# --- dispatch helpers ---------------------------------------------------------


def route(k: int, n: int, *operands: torch.Tensor,
          dac_bits: int = 0) -> str:
    """The kernel route for a stage contracting over ``k`` into ``n``
    output columns: ``"tensor_core"`` when k (> 0) and n are multiples of
    4, every operand's data is 16-byte aligned (TMA's rule for bases and
    row strides) and ``dac_bits`` (stage 1's DAC) is at most 23, ``"fma"``
    otherwise."""
    if (k > 0 and k % 4 == 0 and n % 4 == 0
            and dac_bits <= _TC_MAX_DAC_BITS
            and all(t.data_ptr() % _TMA_ALIGN == 0 for t in operands)):
        return "tensor_core"
    return "fma"


def tc_split(stage: int, m: int, k: int, n: int) -> int:
    """CTAs of one cluster that share an output tile's contraction on the
    tensor-core route (1, 2 or 4), from the shapes alone, never the batch.

    A tile is ``TC_ROWS`` rows of the register operand (stage 1: n, stage
    2: m) by ``TC_W_ROWS`` rows of W (stage 1: m, stage 2: n).  The split
    doubles while one frame's CTAs stay within ``_FRAME_CTAS`` and each
    CTA keeps at least two ``TC_STEP``-deep k steps; CTA r of the cluster
    takes steps [r * per, (r + 1) * per), per = ceil(steps / split).  A
    512x512 frame is 32 tiles split 2 ways.

    ``_FRAME_CTAS`` is a fill target tuned on a 132-SM H100 with the
    offload flush at two frames a launch (its memory budget's
    ``tile_k`` of 2 there): half the card a frame, so two frames make one
    wave.  A card with another SM count or a budget with another
    ``tile_k`` would want the target measured again (``chip_smoke.py``'s
    split scan).  Whatever the target, the split depends on the shapes
    alone, so a frame's bits never depend on the batch.
    """
    rows, w_rows = (n, m) if stage == 1 else (m, n)
    tiles = -(-rows // TC_ROWS) * -(-w_rows // TC_W_ROWS)
    steps = -(-k // TC_STEP)
    split = 1
    while (split < 4 and tiles * split * 2 <= _FRAME_CTAS
           and steps >= 4 * split):
        split *= 2
    return split


def _levels(dac_bits: int) -> int:
    if dac_bits < 0:
        raise ValueError("dac_bits must be >= 0")
    return (1 << dac_bits) - 1 if dac_bits else 0


def _check_blocks(**blocks: int) -> None:
    for name, b in blocks.items():
        if not isinstance(b, int) or b < 1:
            raise ValueError(f"{name} must be a positive int, got {b!r}")


def _on_cpu(name: str, *ts: torch.Tensor) -> bool:
    """True when every operand lies on the CPU (take the plain version),
    False when all lie on one CUDA device (launch the kernel); raises on
    anything else."""
    devices = {t.device for t in ts}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: operands must all lie on the CPU or on "
                         f"one CUDA device, got {sorted(map(str, devices))}")
    for t in ts:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32 "
                            f"operands, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous "
                             "operands")
    return False


def _pin_fp32() -> None:
    """Plain versions on the card must not drop to TF32: the reference
    accumulates in full fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, built on first use, with every argument typed
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)."""
    from repro_torch.kernels.build import library
    lib = library("optical_dft")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.optical_dft_stage1_batched.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.optical_dft_stage1_batched.restype = i
    lib.optical_dft_stage2_batched.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.optical_dft_stage2_batched.restype = i
    lib.optical_dft_error_string.argtypes = [i]
    lib.optical_dft_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.optical_dft_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


# --- stage 1: T[b] = W @ quantize(A[b]), A real ------------------------------


def dft_stage1_batched_plain(wr: torch.Tensor, wi: torch.Tensor,
                             a: torch.Tensor, *, dac_bits: int = 0,
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch stage 1: fp32 ``torch.matmul`` on the (re, im) planes."""
    if a.is_cuda:
        _pin_fp32()
    a = a.to(torch.float32)
    levels = _levels(dac_bits)
    if levels:
        a = torch.round(torch.clamp(a, 0.0, 1.0) * levels) / levels
    return (torch.matmul(wr.to(torch.float32), a),
            torch.matmul(wi.to(torch.float32), a))


@charged()
def dft_stage1_batched(wr: torch.Tensor, wi: torch.Tensor, a: torch.Tensor,
                       *, dac_bits: int = 0, bb: int = 1, bm: int = 128,
                       bk: int = 128, bn: int = 128,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """T[b] = W @ quantize_dac(A[b]) for a whole batch in ONE launch.

    W: (m, k) complex as (wr, wi); A: (batch, k, n) real; returns the
    (re, im) planes of T, each (batch, m, n) float32.  ``dac_bits=0``
    turns the DAC off.  The factor matrices are shared by every frame.
    """
    _check_blocks(bb=bb, bm=bm, bk=bk, bn=bn)
    if a.ndim != 3 or wr.ndim != 2 or wr.shape != wi.shape:
        raise ValueError(f"dft_stage1_batched: expected W (m, k) x2 and A "
                         f"(batch, k, n), got {tuple(wr.shape)}, "
                         f"{tuple(wi.shape)}, {tuple(a.shape)}")
    batch, kdim, n = a.shape
    m, kw = wr.shape
    if kw != kdim:
        raise ValueError(f"dft_stage1_batched: W has k={kw}, A has k={kdim}")
    levels = _levels(dac_bits)
    if _on_cpu("dft_stage1_batched", wr, wi, a):
        return dft_stage1_batched_plain(wr, wi, a, dac_bits=dac_bits)
    if batch > _MAX_GRID_Z:
        raise ValueError(f"dft_stage1_batched: batch {batch} exceeds "
                         f"{_MAX_GRID_Z}")
    tr = torch.empty((batch, m, n), dtype=torch.float32, device=a.device)
    ti = torch.empty_like(tr)
    path = route(kdim, n, wr, wi, a, dac_bits=dac_bits)
    split = tc_split(1, m, kdim, n) if path == "tensor_core" else 1
    lib = _lib()
    with torch.cuda.device(a.device):   # the C entry launches on it
        code = lib.optical_dft_stage1_batched(
            wr.data_ptr(), wi.data_ptr(), a.data_ptr(), tr.data_ptr(),
            ti.data_ptr(), batch, m, kdim, n, levels, _ROUTE_CODE[path],
            split, _stream(a))
    _raise_on(lib, "dft_stage1_batched", code)
    dft_stage1_batched.launches += 1
    dft_stage1_batched.launches_by_route[path] += 1
    return tr, ti


def dft_stage1(wr: torch.Tensor, wi: torch.Tensor, a: torch.Tensor, *,
               dac_bits: int = 0, bm: int = 128, bk: int = 128,
               bn: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """T = W @ quantize_dac(A).  W: (m, k) complex as (wr, wi); A: (k, n)
    real.  The batched kernel at a leading axis of 1."""
    if a.ndim != 2:
        raise ValueError(f"dft_stage1: expected A (k, n), got "
                         f"{tuple(a.shape)}")
    tr, ti = dft_stage1_batched(wr, wi, a.unsqueeze(0), dac_bits=dac_bits,
                                bm=bm, bk=bk, bn=bn)
    return tr[0], ti[0]


# --- stage 2: I[b] = |T[b] @ W^T|^2 -------------------------------------------


def dft_stage2_batched_plain(tr: torch.Tensor, ti: torch.Tensor,
                             wr: torch.Tensor, wi: torch.Tensor,
                             ) -> torch.Tensor:
    """Plain PyTorch stage 2: four fp32 real ``torch.matmul`` against W's
    rows, then the square-law detector."""
    if tr.is_cuda:
        _pin_fp32()
    tr, ti = tr.to(torch.float32), ti.to(torch.float32)
    wrt, wit = wr.to(torch.float32).T, wi.to(torch.float32).T
    ur = torch.matmul(tr, wrt) - torch.matmul(ti, wit)
    ui = torch.matmul(tr, wit) + torch.matmul(ti, wrt)
    return ur * ur + ui * ui


@charged()
def dft_stage2_batched(tr: torch.Tensor, ti: torch.Tensor, wr: torch.Tensor,
                       wi: torch.Tensor, *, bb: int = 1, bm: int = 128,
                       bk: int = 128, bn: int = 128) -> torch.Tensor:
    """I[b] = |T[b] @ W^T|^2 for a whole batch in ONE launch.

    T: (batch, m, k) complex as (tr, ti); W: (n, k) complex; returns I
    (batch, m, n) float32.  T is read once and never written back: only
    the detector intensity leaves the kernel.
    """
    _check_blocks(bb=bb, bm=bm, bk=bk, bn=bn)
    if (tr.ndim != 3 or tr.shape != ti.shape or wr.ndim != 2
            or wr.shape != wi.shape):
        raise ValueError(f"dft_stage2_batched: expected T (batch, m, k) x2 "
                         f"and W (n, k) x2, got {tuple(tr.shape)}, "
                         f"{tuple(ti.shape)}, {tuple(wr.shape)}, "
                         f"{tuple(wi.shape)}")
    batch, m, kdim = tr.shape
    n, kw = wr.shape
    if kw != kdim:
        raise ValueError(f"dft_stage2_batched: W has k={kw}, T has k={kdim}")
    if _on_cpu("dft_stage2_batched", tr, ti, wr, wi):
        return dft_stage2_batched_plain(tr, ti, wr, wi)
    if batch > _MAX_GRID_Z:
        raise ValueError(f"dft_stage2_batched: batch {batch} exceeds "
                         f"{_MAX_GRID_Z}")
    out = torch.empty((batch, m, n), dtype=torch.float32, device=tr.device)
    path = route(kdim, n, tr, ti, wr, wi)
    split = tc_split(2, m, kdim, n) if path == "tensor_core" else 1
    lib = _lib()
    with torch.cuda.device(tr.device):  # the C entry launches on it
        code = lib.optical_dft_stage2_batched(
            tr.data_ptr(), ti.data_ptr(), wr.data_ptr(), wi.data_ptr(),
            out.data_ptr(), batch, m, kdim, n, _ROUTE_CODE[path], split,
            _stream(tr))
    _raise_on(lib, "dft_stage2_batched", code)
    dft_stage2_batched.launches += 1
    dft_stage2_batched.launches_by_route[path] += 1
    return out


def dft_stage2(tr: torch.Tensor, ti: torch.Tensor, wr: torch.Tensor,
               wi: torch.Tensor, *, bm: int = 128, bk: int = 128,
               bn: int = 128) -> torch.Tensor:
    """I = |T @ W^T|^2.  T: (m, k) complex; W: (n, k) complex; I: (m, n).
    The batched kernel at a leading axis of 1."""
    if tr.ndim != 2:
        raise ValueError(f"dft_stage2: expected T (m, k), got "
                         f"{tuple(tr.shape)}")
    return dft_stage2_batched(tr.unsqueeze(0), ti.unsqueeze(0), wr, wi,
                              bm=bm, bk=bk, bn=bn)[0]


def reset_launches() -> None:
    """Set both kernels' launch counters, in all and per route, to 0."""
    for fn in (dft_stage1_batched, dft_stage2_batched):
        fn.launches = 0
        fn.launches_by_route = dict.fromkeys(ROUTES, 0)


reset_launches()


# --- composites ----------------------------------------------------------------


def optical_dft2_intensity(a: torch.Tensor, *, dac_bits: int = 8,
                           block: int = 128) -> torch.Tensor:
    """Full fused pipeline: detector intensity of the 2-D unitary DFT of ``a``.

    Matches ``repro_torch.core.optical`` with amplitude encoding, no noise,
    and no ADC quantization.
    """
    h, w = a.shape
    whr, whi = dft_matrix_factors(h, device=a.device)
    wwr, wwi = dft_matrix_factors(w, device=a.device)
    tr, ti = dft_stage1(whr, whi, a, dac_bits=dac_bits,
                        bm=block, bk=block, bn=block)
    return dft_stage2(tr, ti, wwr, wwi, bm=block, bk=block, bn=block)


def optical_dft2_intensity_batched(a: torch.Tensor, *, dac_bits: int = 8,
                                   block: int = 128, bb: int = 1,
                                   ) -> torch.Tensor:
    """Batched fused pipeline: ``a`` is (batch, h, w), output (batch, h, w).

    Two kernel launches for the whole batch on the card; the factor
    matrices are built once per call and shared by every frame.
    """
    _, h, w = a.shape
    whr, whi = dft_matrix_factors(h, device=a.device)
    wwr, wwi = dft_matrix_factors(w, device=a.device)
    tr, ti = dft_stage1_batched(whr, whi, a, dac_bits=dac_bits, bb=bb,
                                bm=block, bk=block, bn=block)
    return dft_stage2_batched(tr, ti, wwr, wwi, bb=bb, bm=block, bk=block,
                              bn=block)
