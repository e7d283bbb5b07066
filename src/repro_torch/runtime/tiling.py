"""Memory-budgeted tiled dispatch: how big a batched stack may get.

Batching amortizes the conversion boundary (one handshake, one settle, one
lane-ceil residue per invocation instead of per call), but the *stack* that
buys the amortization is a real allocation on the digital side of the
boundary: a ``(K, H, W)`` flush group materializes K frames plus the
pipeline's complex intermediates before anything crosses the DAC.  At
128x128 that working set is noise; at 512x512 and K=16 it is ~64 MB — it
falls out of the CPU's last-level cache (a monolithic batched FFT
measures *slower* than a Python loop of singles) and exceeds the 50 MB L2
cache of an H100.  The photonic case studies make the same
point from the hardware side: sustained throughput is set by how operands
are *staged* into the analog aperture, not by the transform itself.

This module decides the staging granularity from a per-device byte budget:

  :class:`MemoryBudget`   where the bytes come from — L2-derived on CUDA,
                          LLC-derived on the CPU, or operator-pinned — and how
                          many frames of a given working set fit inside it.
  :func:`choose_tile`     pick ``tile_k``: the deepest sub-stack whose
                          working set (times the pipeline depth — two tiles
                          are in flight under double buffering) fits the
                          budget.  A released flush group of K calls then
                          streams through the executor's existing two-deep
                          async pipeline as ``ceil(K / tile_k)``
                          sub-invocations with write/analog/read overlap
                          *between* tiles, instead of one monolithic stack.
  :func:`choose_blocks`   pick the batched DFT stages' block plan
                          ``(bb, bm, bk, bn)`` from the budget instead
                          of the fixed 128-cube defaults.

``tile_k = 1`` degenerates to the looped regime (one call per crossing),
``tile_k >= K`` to the monolithic one — both are valid points on the same
curve, which is exactly why the runtime-equivalence invariant extends to
tiling: tiled == monolithic == looped on every backend, ragged tails
included (``tests/test_tiling.py``).

The same model is consumed by the cost side: both accelerator families'
``batched_step_cost`` accept ``tile_k=`` / ``mem_budget=`` (duck-typed via
:meth:`MemoryBudget.tile_for`, so ``repro_torch.core`` never imports this
package) and price the tiled stream as executed — every tile pays its own
per-invocation prologue, the tiles overlap two-deep.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import subprocess

import torch

# One definition of the group split, shared with both accelerator
# families' cost models: dispatch, warm(), and batched_step_cost(tile_k=)
# all slice a group identically (re-exported here for runtime callers).
from repro_torch.core.accelerator import tile_sizes

__all__ = [
    "BYTES_F32",
    "LLC_FALLBACK_BYTES",
    "MemoryBudget",
    "TilePlan",
    "BlockPlan",
    "choose_tile",
    "choose_blocks",
    "tile_sizes",
]

BYTES_F32 = 4

# CPU fallback when the platform exposes no cache topology: a
# mainstream server LLC.  Detection prefers the real number (sysfs /
# getconf) — the fallback only anchors containers that hide both.
LLC_FALLBACK_BYTES = 32 * 1024 * 1024

# Working-set multiplier per boundary sample: one float32 in, one float32
# out, plus ~two floats of complex/stage intermediates per sample while
# the batched pipeline runs (fft carries (re, im) stage-1 planes; conv a
# complex Fourier product; matmul a differential readout pair).  A model,
# not a measurement — telemetry records the *measured* bytes/frame of real
# traffic (``RuntimeTelemetry.bytes_per_frame``) so a replan can see how
# tight the model ran.
_INTERMEDIATE_FACTOR = 2.0


def _parse_size(text: str) -> int:
    """Parse a sysfs cache size string ('56623104', '32768K', '54M')."""
    text = text.strip()
    mult = 1
    if text[-1:].upper() in ("K", "M", "G"):
        mult = {"K": 1024, "M": 1024 ** 2, "G": 1024 ** 3}[text[-1].upper()]
        text = text[:-1]
    return int(text) * mult


@functools.lru_cache(maxsize=1)
def _llc_bytes() -> int:
    """Last-level cache size in bytes (largest of L3/L2 reported).

    Tries sysfs, then ``getconf LEVEL{3,2}_CACHE_SIZE`` (glibc reads the
    same CPUID leaves sysfs exposes; containers often mount neither), then
    falls back to :data:`LLC_FALLBACK_BYTES`.
    """
    for idx in (3, 2):
        try:
            with open("/sys/devices/system/cpu/cpu0/cache/"
                      f"index{idx}/size") as f:
                size = _parse_size(f.read())
            if size > 0:
                return size
        except (OSError, ValueError):
            pass
    for level in ("LEVEL3_CACHE_SIZE", "LEVEL2_CACHE_SIZE"):
        try:
            out = subprocess.run(["getconf", level], capture_output=True,
                                 text=True, timeout=5)
            size = int(out.stdout.strip() or 0)
            if size > 0:
                return size
        except (OSError, ValueError, subprocess.SubprocessError):
            pass
    return LLC_FALLBACK_BYTES


@dataclasses.dataclass(frozen=True)
class MemoryBudget:
    """A per-device byte budget for staging batched operand stacks.

    Attributes:
      bytes_limit: total budgeted bytes; ``0`` (or negative) means
        *unlimited* — tiling is disabled and every group dispatches
        monolithically, the pre-tiling behavior.
      source: where the number came from (``"l2"`` / ``"llc"`` /
        ``"manual"`` / ``"unlimited"``) — stamped into benchmarks so a
        recorded ``tile_k`` stays interpretable across machines.
      reserve: fraction of ``bytes_limit`` actually spendable on operand
        staging.  The rest is headroom for everything the model does not
        count — library temporaries, the host program, other cores sharing the
        LLC.  ``spendable = bytes_limit * reserve``.
    """

    bytes_limit: int
    source: str = "manual"
    reserve: float = 0.5

    def __post_init__(self) -> None:
        if not 0.0 < self.reserve <= 1.0:
            raise ValueError("reserve must be in (0, 1]")

    @classmethod
    def detect(cls, device: "str | object | None" = None) -> "MemoryBudget":
        """The device's budget: L2-derived on CUDA, LLC-derived on the CPU.

        On a CUDA card the binding constraint is the L2 cache
        (``torch.cuda.get_device_properties(dev).L2_cache_size``, 50 MB on
        an H100): a batched stack larger than L2 streams every pass over
        it from device memory (reserve 0.5: the DFT factors, the stage-1
        planes and the library's temporaries share it).  On the CPU it is
        the last-level cache — a batched stack larger than the LLC turns
        every pass over it into a DRAM stream, which is precisely where
        monolithic batching measures slower than looping (reserve 0.5: the
        LLC is shared with everything else on the host).  ``device=None``
        means the CUDA card, and raises when there is none, as the
        executor's default device does: a CPU budget is always asked for
        (``detect("cpu")``).
        """
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "MemoryBudget.detect() sizes the CUDA card's budget by "
                    "default and none is available; pass device='cpu' for "
                    "the CPU's")
            device = "cuda"
        dev = torch.device(device)
        if dev.type == "cuda":
            props = torch.cuda.get_device_properties(dev)
            return cls(int(props.L2_cache_size), source="l2", reserve=0.5)
        return cls(_llc_bytes(), source="llc", reserve=0.5)

    @classmethod
    def unlimited(cls) -> "MemoryBudget":
        """No budget: monolithic dispatch (the pre-tiling regime)."""
        return cls(0, source="unlimited", reserve=1.0)

    @property
    def is_unlimited(self) -> bool:
        return self.bytes_limit <= 0

    @property
    def spendable_bytes(self) -> int:
        return int(self.bytes_limit * self.reserve)

    def frames_within(self, bytes_per_frame: int,
                      pipeline_depth: int = 1) -> int | None:
        """How many frames of ``bytes_per_frame`` working set fit.

        ``pipeline_depth`` multiplies the footprint: under double
        buffering two tiles are alive at once (tile t's analog+read in
        flight while tile t+1 stages), so each budgeted frame costs
        ``depth`` times its bytes.  Returns None when unlimited; always
        at least 1 otherwise (a single frame must dispatch even when it
        alone overflows the budget — there is no smaller unit).
        """
        if self.is_unlimited:
            return None
        if bytes_per_frame <= 0:
            raise ValueError("bytes_per_frame must be positive")
        depth = max(1, int(pipeline_depth))
        return max(1, self.spendable_bytes // (bytes_per_frame * depth))

    def tile_for(self, n_in: int, n_out: int | None = None, *,
                 pipeline_depth: int = 2,
                 dtype_bytes: int = BYTES_F32) -> int | None:
        """Budget frame cap under the standard working-set model.

        One frame's working set = ``dtype_bytes * (n_in + n_out) *
        _INTERMEDIATE_FACTOR`` (operand in, result out, pipeline
        intermediates).  This is the ONE place the model lives — every
        consumer goes through it.  Returns None when unlimited.
        """
        if n_out is None:
            n_out = n_in
        bytes_per_frame = int(dtype_bytes * (n_in + n_out)
                              * _INTERMEDIATE_FACTOR)
        return self.frames_within(max(1, bytes_per_frame), pipeline_depth)

    def minus(self, resident_bytes: int) -> "MemoryBudget":
        """The budget left for staging after ``resident_bytes`` of the
        spendable pool are pinned elsewhere (the operand residency cache:
        resident stacks are live allocations in the same physical pool the
        tiles stage through, so a fuller cache must mean a shallower
        tile).  An unlimited budget stays unlimited; otherwise the limit
        shrinks by the pinned bytes' pre-reserve share, floored at 1 byte —
        never at 0, which would read as *unlimited* and hand a saturated
        cache an infinite staging budget."""
        if self.is_unlimited or resident_bytes <= 0:
            return self
        limit = max(1, self.bytes_limit - int(resident_bytes / self.reserve))
        return dataclasses.replace(self, bytes_limit=limit)

    def tile_for_group(self, n_in: int, n_out: int | None, k: int, *,
                       pipeline_depth: int = 2,
                       dtype_bytes: int = BYTES_F32) -> int:
        """The tile depth a ``k``-deep group actually dispatches at: the
        budget frame cap refined by :func:`choose_tile`'s even-split
        divisor preference.  This is the resolution the executor, the
        router, AND both accelerator families'
        ``batched_step_cost(mem_budget=)`` share (the cost model
        duck-types this method so ``repro_torch.core`` never imports this
        package) — the modeled tiling is the executed tiling, divisor
        refinement included."""
        return choose_tile(n_in, k, self, n_out=n_out,
                           dtype_bytes=dtype_bytes,
                           pipeline_depth=pipeline_depth).tile_k




@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The result of :func:`choose_tile`: how one flush group streams.

    Attributes:
      tile_k: frames per sub-invocation (1 = looped, >= k = monolithic).
      k: the group depth the plan covers.
      bytes_per_frame: the modeled working-set bytes one frame costs.
      budget: the budget the choice was made under.
    """

    tile_k: int
    k: int
    bytes_per_frame: int
    budget: MemoryBudget

    @property
    def monolithic(self) -> bool:
        return self.tile_k >= self.k

    @property
    def tiles(self) -> int:
        return math.ceil(self.k / self.tile_k)

    def sizes(self) -> list[int]:
        return tile_sizes(self.k, self.tile_k)


def choose_tile(n_in: int, k: int, budget: MemoryBudget, *,
                n_out: int | None = None, dtype_bytes: int = BYTES_F32,
                pipeline_depth: int = 2) -> TilePlan:
    """Pick ``tile_k`` for a K-deep group of ``n_in``-sample frames.

    The deepest tile whose working set (times ``pipeline_depth`` — two
    tiles in flight under double buffering) fits the budget, with one
    refinement: when a *divisor* of ``k`` no smaller than half the
    budgeted depth exists, prefer it — an even split avoids a ragged tail
    tile, which is one fewer compiled stack shape and one fewer
    under-filled boundary crossing, at the cost of at most half the
    budgeted amortization depth.
    """
    if n_out is None:
        n_out = n_in
    bytes_per_frame = int(dtype_bytes * (n_in + n_out) * _INTERMEDIATE_FACTOR)
    cap = budget.tile_for(n_in, n_out, pipeline_depth=pipeline_depth,
                          dtype_bytes=dtype_bytes)
    if cap is None or cap >= k:
        tile = k
    else:
        div = max(d for d in range(1, cap + 1) if k % d == 0)
        tile = div if 2 * div > cap else cap
    return TilePlan(tile_k=max(1, tile), k=max(1, k),
                    bytes_per_frame=bytes_per_frame, budget=budget)


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    """Budget-driven block sizes for the batched DFT stages.

    ``bb`` frames ride each grid step (sharing one load of the factor
    blocks); ``bm/bk/bn`` tile the matmul itself.  ``key`` is the
    signature compiled kernels and cached factor matrices are keyed by —
    replanning the budget (hence the blocks) must never silently reuse a
    kernel or factor cached under the old layout.
    """

    bb: int
    bm: int
    bk: int
    bn: int

    @property
    def key(self) -> tuple[int, int, int, int]:
        return (self.bb, self.bm, self.bk, self.bn)


def _stage_block_bytes(bb: int, b: int, dtype_bytes: int = BYTES_F32) -> int:
    """Bytes one batched-DFT grid step holds at square block size
    ``b`` with ``bb`` frames per step: two (b, b) factor blocks, a
    (bb, b, b) operand block, (bb, b, b) of accumulator scratch x2, and a
    (bb, b, b) output block (stage 2's is the widest; stage 1 writes two
    outputs but reads one operand — same total)."""
    return dtype_bytes * (2 * b * b + 4 * bb * b * b)


def choose_blocks(batch: int, m: int, k: int, n: int,
                  budget: MemoryBudget | None, *,
                  preferred: int = 128, max_bb: int = 8) -> BlockPlan:
    """Block sizes for one batched DFT stage from the budget.

    Kept exactly as the reference resolves them, for parity: the CUDA
    kernels validate the plan and tile with their own compile-time
    blocks.  Starts from the ``preferred`` cube and halves until one
    grid step's working set (:func:`_stage_block_bytes`) fits the
    spendable budget; then grows ``bb`` (frames per grid step — they share
    one load of the factor blocks) through the divisors of ``batch`` while
    the footprint still fits, capped at ``max_bb`` to bound kernel unroll.
    With no budget (None / unlimited) the classic ``pick_block`` defaults
    come back unchanged (``bb=1``), so off-budget callers compile exactly
    the kernels they always did.
    """
    from repro_torch.kernels.common import pick_block

    def resolve(b: int) -> tuple[int, int, int]:
        return (pick_block(m, b, 8), pick_block(k, b, 128),
                pick_block(n, b, 128))

    if budget is None or budget.is_unlimited:
        bm, bk, bn = resolve(preferred)
        return BlockPlan(bb=1, bm=bm, bk=bk, bn=bn)
    spend = budget.spendable_bytes
    b = preferred
    while b > 8 and _stage_block_bytes(1, b) > spend:
        b //= 2
    bm, bk, bn = resolve(b)
    side = max(bm, bk, bn)
    bb = 1
    for d in range(2, min(batch, max_bb) + 1):
        if batch % d == 0 and _stage_block_bytes(d, side) <= spend:
            bb = d
    return BlockPlan(bb=bb, bm=bm, bk=bk, bn=bn)
