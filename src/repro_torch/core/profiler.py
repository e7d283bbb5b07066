"""Application profiling: per-op-category time and FLOP attribution.

Two complementary profilers, mirroring the paper's methodology (App. C.1 —
cProfile with FFT/conv-named functions attributed to the accelerator):

* ``OpProfiler`` — wall-clock accumulation by category, used by the
  27-benchmark Amdahl suite (``repro_torch.casestudy.amdahl_suite``).
  Callers bracket accelerable ops with ``prof.run("fft", fn, ...)`` or
  ``prof.op("fft")`` and the suite builds Table-1 rows from the totals.
* ``flops_by_category`` — attribution by counting: runs ``fn`` under a
  ``TorchDispatchMode`` that sees every aten op it dispatches and buckets
  FLOPs into {matmul, conv, fft, other}; ``traffic_bytes`` sums the bytes
  those ops read and write.  This is how the planner evaluates offload
  for an LM architecture without timing it.

The reference walks a jaxpr instead.  Counting eagerly changes three
things.  A Python loop runs and is counted trip by trip, so the
reference's ``scan`` multiplier is implicit and its
``__while_unknown_trips__`` flag never appears (where a shape-only run
would walk a long loop over time, the xLSTM cells on ``meta``, the model
runs one trip under :func:`repeated` instead, which multiplies what that
trip counts, forward and backward, by the trip count); a branch counts
the side that ran, where the reference's ``cond`` averages its
branches.  Shapes alone are counted by passing tensors on
``device="meta"``, the counterpart of the reference's
``ShapeDtypeStruct`` arguments.

Under a mesh the arguments may be DTensors.  The counting mode then steps
aside for them (it returns ``NotImplemented``, as torch's
``CommDebugMode`` does), so DTensor desugars each op into this rank's
local ops and its collectives, and the mode counts those: FLOPs and
bytes per device, and the bytes of every ``_c10d_functional``
collective by kind (:func:`count_step`), each counted as max(result,
operand), the reference's rule for its partitioned HLO
(``repro.launch.dryrun.collective_bytes``).  A collective and its
``wait_tensor`` count once.  A Shard-to-Shard redistribute (DTensor's
``shard_dim_alltoall``) counts as one all-to-all of max(operand, result),
whatever its process group does beneath it: on a ``cpu`` mesh (gloo, the
fake group of the dry run) DTensor falls back to an all-gather and a
local chunk, which are not counted, where NCCL sends the all-to-all.
The ops DTensor runs on ``FakeTensor``s to propagate shapes are not the
step's work and count nothing.  On plain
tensors nothing of this applies and every count is what it was.

The port's hand-written kernels launch through ``ctypes`` and dispatch no
aten op, so a dispatch mode cannot see them.  Their wrappers are
decorated with ``repro_torch.kernels.common.charged``: under
``flops_by_category`` a wrapper's call charges the work the reference's
walk gives the same call once, and nothing inside its body is counted, on
every device.  The count is then the same on ``cuda``, ``cpu`` and
``meta``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
import sys
import time
from typing import Any, Callable, Iterable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpProfiler", "flops_by_category", "traffic_bytes",
           "count_step", "Counts", "repeated", "COLLECTIVE_KINDS",
           "OFFLOADABLE_CATEGORIES"]

OFFLOADABLE_CATEGORIES = ("fft", "conv", "matmul")


def _arrays(tree: Any) -> list:
    """The leaves of ``tree`` that have a shape (tensors, numpy arrays):
    what the reference counts as array leaves.  Python scalars do not."""
    return [x for x in pytree.tree_leaves(tree) if hasattr(x, "shape")]


def _sync(tensors: Iterable) -> None:
    """Wait for every CUDA device that holds one of ``tensors``."""
    for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _sync_current() -> None:
    """Wait for the current CUDA device, if this process has used one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class OpProfiler:
    """Accumulates wall time by op category.

    Uses ``time.perf_counter``.  CUDA runs asynchronously, so on the card
    a bracket synchronizes on entry and on exit: work queued before it
    finishes outside it (and lands in the 'other' residual), and its own
    work finishes inside it.  ``run`` waits for the devices of its tensors,
    ``op`` (which sees no tensors), ``start`` and ``stop`` for the current
    device.  On the CPU nothing is waited for.
    """

    def __init__(self) -> None:
        self.seconds: dict[str, float] = collections.defaultdict(float)
        self.calls: dict[str, int] = collections.defaultdict(int)
        self.samples_in: dict[str, int] = collections.defaultdict(int)
        self.samples_out: dict[str, int] = collections.defaultdict(int)
        self._t0: float | None = None

    # -- session -------------------------------------------------------------
    def start(self) -> None:
        _sync_current()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("profiler not started")
        _sync_current()
        total = time.perf_counter() - self._t0
        self.seconds["__total__"] += total
        self._t0 = None
        return total

    # -- op bracketing ---------------------------------------------------------
    @contextlib.contextmanager
    def op(self, category: str, n_in: int = 0, n_out: int = 0):
        _sync_current()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync_current()
            self.seconds[category] += time.perf_counter() - t0
            self.calls[category] += 1
            self.samples_in[category] += int(n_in)
            self.samples_out[category] += int(n_out)

    def run(self, category: str, fn: Callable, *args, **kwargs):
        """Run ``fn`` under ``category``, waiting for its outputs."""
        inputs = _arrays((args, kwargs))
        _sync(inputs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        outputs = _arrays(out)
        _sync(inputs + outputs)
        dt = time.perf_counter() - t0
        self.seconds[category] += dt
        self.calls[category] += 1
        self.samples_in[category] += sum(math.prod(a.shape) for a in inputs)
        self.samples_out[category] += sum(math.prod(a.shape)
                                          for a in outputs)
        return out

    # -- reporting --------------------------------------------------------------
    @property
    def total_s(self) -> float:
        return self.seconds.get("__total__", 0.0)

    def accelerable_s(self, categories=("fft", "conv")) -> float:
        return sum(self.seconds.get(c, 0.0) for c in categories)

    def fraction(self, categories=("fft", "conv")) -> float:
        tot = self.total_s
        return 0.0 if tot == 0.0 else min(self.accelerable_s(categories) / tot,
                                          1.0)


# --- FLOP attribution by dispatch ---------------------------------------------

_aten = torch.ops.aten
_MATMUL = {_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}
_FFT = {_aten._fft_c2c, _aten._fft_r2c, _aten._fft_c2r}
# view ops whose schema does not say so
_METADATA = {_aten._unsafe_view}


def _is_view(func) -> bool:
    return func.is_view or func.overloadpacket in _METADATA


def _is_sdpa(func) -> bool:
    """A fused scaled-dot-product attention forward (flash, efficient,
    cuDNN, the CPU flash kernel)."""
    name = func.overloadpacket.__name__
    return name.startswith("_scaled_dot_product") and "backward" not in name


def _matmul_flops(func, args) -> float:
    """2·batch·m·n·k, as the reference counts a ``dot_general``."""
    p = func.overloadpacket
    if p in (_aten.addmm, _aten.baddbmm):
        args = args[1:]                 # (bias, a, b, ...)
    a, b = args[0], args[1]
    return 2.0 * math.prod(a.shape) * b.shape[-1]


def _sdpa_flops(args) -> float:
    """Its two products: 2·B·H·L·S·E for the scores, 2·B·H·L·S·Ev for the
    output (q (B,H,L,E), k (B,H,S,E), v (B,H,S,Ev))."""
    q, k, v = args[0], args[1], args[2]
    lead = math.prod(q.shape[:-1])      # B·H·L
    s = k.shape[-2]
    return 2.0 * lead * s * (q.shape[-1] + v.shape[-1])


def _conv_flops(args, out) -> float:
    """2·out_elems·(in_ch/groups)·prod(kernel), as the reference counts a
    ``conv_general_dilated``."""
    x, w, groups = args[0], args[1], args[8]
    return (2.0 * math.prod(out.shape) * (x.shape[1] // groups)
            * math.prod(w.shape[2:]))


def _fft_flops(func, args, out) -> float:
    """5·batch·n·log2(n), n the product of the transformed lengths (the
    output's, for a complex-to-real transform) and batch the input's
    elements over n, as the reference counts an ``fft``."""
    x, dims = args[0], args[1]
    lengths = out if func.overloadpacket is _aten._fft_c2r else x
    n = float(math.prod(lengths.shape[d] for d in dims))
    batch = math.prod(x.shape) / max(n, 1.0)
    return 5.0 * batch * n * max(math.log2(max(n, 2.0)), 1.0)


# the reference's collective kinds (its partitioned HLO's op names), by the
# name of the ``_c10d_functional`` op (or DTensor's own all-to-all) that
# does the same
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
_KIND_BY_PREFIX = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
                   ("reduce_scatter", "reduce-scatter"),
                   ("all_to_all", "all-to-all"),
                   ("shard_dim_alltoall", "all-to-all"),
                   ("permute", "collective-permute"))
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor")
_MOVES_NOTHING = ("wait_tensor", "_wrap_tensor_autograd")
_FAKE = torch._C._TorchDispatchModeKey.FAKE


def _collective_kind(func) -> str | None:
    """The collective kind of a ``_c10d_functional`` / ``_dtensor`` op
    (any other collective under its own op name); "" for the ones that
    move nothing (``wait_tensor``, the autograd wrap); None for any other
    op."""
    if func.namespace not in _COLLECTIVE_NAMESPACES:
        return None
    name = func.overloadpacket.__name__
    if name in _MOVES_NOTHING:
        return ""
    for prefix, kind in _KIND_BY_PREFIX:
        if name.startswith(prefix):
            return kind
    return name


def _wrapper_types() -> tuple[type, ...]:
    """Tensor subclasses the counting mode steps aside for: DTensor (its
    dispatch then runs the local ops and collectives, which the mode
    counts) and the functional collectives' async wrapper."""
    from torch.distributed._functional_collectives import AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor
    return DTensor, AsyncCollectiveTensor


def _tensors(tree: Any) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(tensors: Iterable) -> float:
    """Bytes of the tensors that have a shape (0-dim ones are skipped, as
    the reference skips shapeless operands)."""
    return float(sum(t.numel() * t.element_size() for t in tensors
                     if t.dim()))


def _counting_alltoall(orig: Callable) -> Callable:
    """DTensor's ``shard_dim_alltoall`` as each active counter counts it:
    one all-to-all of max(operand, result) bytes, and nothing of what
    ``orig`` runs beneath it (an all-gather and a chunk on a ``cpu``
    mesh, the all-to-all op under NCCL).  ``orig`` itself runs as it
    would."""
    @functools.wraps(orig)
    def shard_dim_alltoall(input, *args, **kwargs):
        from torch.utils._python_dispatch import \
            _get_current_dispatch_mode_stack
        counters = [c for c in _get_current_dispatch_mode_stack()
                    if isinstance(c, _Counter) and not c._paused]
        for c in counters:
            c._paused += 1
        try:
            out = orig(input, *args, **kwargs)
        finally:
            for c in counters:
                c._paused -= 1
        for c in counters:
            moved = c.trips * max(_bytes([input]), _bytes([out]))
            c.collectives["all-to-all"] += moved
            c.shard_to_shard["calls"] += c.trips
            c.shard_to_shard["bytes"] += moved
        return out
    shard_dim_alltoall.counting = True
    return shard_dim_alltoall


# the modules that call DTensor's Shard-to-Shard all-to-all by name
_ALLTOALL_CALLERS = ("torch.distributed.tensor.placement_types",
                     "torch.distributed.tensor._collective_utils")


def _in_shard_dim_alltoall() -> bool:
    """Whether DTensor's own ``shard_dim_alltoall`` is on the Python stack:
    a collective counted there is its CPU route's all-gather, which a
    call that bypassed :func:`_counting_alltoall` would count."""
    from torch.distributed.tensor import _collective_utils
    fn = _collective_utils.shard_dim_alltoall
    code = getattr(fn, "__wrapped__", fn).__code__
    f = sys._getframe(1)
    while f is not None:
        if f.f_code is code:
            return True
        f = f.f_back
    return False


@contextlib.contextmanager
def _alltoall_counted():
    """DTensor's ``shard_dim_alltoall`` counted by :func:`_counting_alltoall`
    in the modules that call it, while a count runs (a nested count
    leaves the first one's in place)."""
    import importlib
    patched = []
    for name in _ALLTOALL_CALLERS:
        mod = importlib.import_module(name)
        orig = getattr(mod, "shard_dim_alltoall", None)
        if orig is not None and not getattr(orig, "counting", False):
            mod.shard_dim_alltoall = _counting_alltoall(orig)
            patched.append((mod, orig))
    try:
        yield
    finally:
        for mod, orig in patched:
            mod.shard_dim_alltoall = orig


class _Counter(TorchDispatchMode):
    """Counts FLOPs by category and bytes moved for every aten op.

    Kernel wrappers find it through ``charge_kernel`` (duck-typed, so the
    kernels need not import this module) and pause it for their body."""

    def __init__(self) -> None:
        super().__init__()
        self.flops: dict[str, float] = collections.defaultdict(float)
        self.bytes = 0.0
        self.collectives: dict[str, float] = collections.defaultdict(float)
        # Shard-to-Shard redistributes counted as all-to-all, and
        # collectives counted inside DTensor's own all-to-all (0 unless a
        # caller bypassed ``_counting_alltoall``)
        self.shard_to_shard = {"calls": 0, "bytes": 0.0,
                               "fallback_collectives": 0}
        self._paused = 0
        self.trips = 1      # what one op counts for (``repeated``)
        self._wrappers = _wrapper_types()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if torch._C._get_dispatch_mode(_FAKE) is not None:
            # DTensor propagating shapes on fake tensors: not the step's
            return func(*args, **kwargs)
        if any(issubclass(t, self._wrappers) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self._paused or _is_view(func):
            return out
        outs = _tensors(out)
        kind = _collective_kind(func)
        if kind is not None:
            if kind and _in_shard_dim_alltoall():
                self.shard_to_shard["fallback_collectives"] += 1
            if kind:
                self.collectives[kind] += self.trips * max(
                    _bytes(_tensors((args, kwargs))), _bytes(outs))
            return out
        p = func.overloadpacket
        if p in _MATMUL:
            cat, n = "matmul", _matmul_flops(func, args)
        elif _is_sdpa(func):
            cat, n = "matmul", _sdpa_flops(args)
        elif p is _aten.convolution:
            cat, n = "conv", _conv_flops(args, outs[0])
        elif p in _FFT:
            cat, n = "fft", _fft_flops(func, args, outs[0])
        else:
            cat, n = "other", float(sum(t.numel() for t in outs))
        self.flops[cat] += self.trips * n
        self.bytes += self.trips * (_bytes(_tensors((args, kwargs)))
                                    + _bytes(outs))
        return out

    def charge_kernel(self, work: dict[str, float], fn: Callable,
                      *args, **kwargs):
        """Run a kernel wrapper's body uncounted and charge ``work`` plus
        one 'other' FLOP per output element and the bytes of its tensor
        operands and outputs: what the reference's walk gives a
        ``pallas_call``.  A call nested in a charged one is not charged
        again."""
        if self._paused:
            return fn(*args, **kwargs)
        self._paused += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._paused -= 1
        outs = _tensors(out)
        for cat, v in work.items():
            self.flops[cat] += self.trips * v
        self.flops["other"] += self.trips * float(sum(t.numel()
                                                      for t in outs))
        self.bytes += self.trips * (_bytes(_tensors((args, kwargs)))
                                    + _bytes(outs))
        return out


@contextlib.contextmanager
def repeated(trips: int):
    """Count every op run inside as ``trips`` ops, in each active
    counting mode (nothing changes when none is active): a loop body run
    once stands for the whole loop, the reference's scan multiplier."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    modes = [m for m in _get_current_dispatch_mode_stack()
             if isinstance(m, _Counter)]
    for m in modes:
        m.trips *= trips
    try:
        yield
    finally:
        for m in modes:
            m.trips //= trips


@dataclasses.dataclass
class Counts:
    """What one counted run of a function did (on DTensors: one device's
    share): FLOPs by category, bytes moved, collective bytes by kind
    (empty on plain tensors), the function's result, and its
    Shard-to-Shard redistributes (calls and bytes, counted as all-to-all;
    ``fallback_collectives``: collectives counted inside DTensor's CPU
    route for them, 0 when every call was counted as the card sends
    it)."""
    flops: dict[str, float]
    bytes: float
    collectives: dict[str, float]
    out: Any
    shard_to_shard: dict = dataclasses.field(default_factory=dict)


def count_step(fn: Callable, *args, **kwargs) -> Counts:
    """One counted run of ``fn``."""
    with _alltoall_counted(), _Counter() as counter:
        out = fn(*args, **kwargs)
    return Counts(dict(counter.flops), counter.bytes,
                  dict(counter.collectives), out,
                  dict(counter.shard_to_shard))


def traffic_bytes(fn: Callable, *args, **kwargs) -> float:
    """Total memory traffic of ``fn``: operand + result bytes of every op
    it dispatches, each loop trip counted.  Fusion-naive (an elementwise
    chain is counted op by op), so this is an *upper bound* on HBM
    traffic, and the consistent numerator for a roofline's memory term.
    View ops move nothing and count nothing."""
    return count_step(fn, *args, **kwargs).bytes


def flops_by_category(fn: Callable, *args, **kwargs) -> dict[str, float]:
    """Run ``fn`` and attribute its FLOPs to {matmul, conv, fft, other}.

    'other' counts one FLOP per produced element of every op that is not
    a contraction, an FFT or a view (a deliberate *under*-estimate of
    memory-bound time: the planner treats 'other' as non-offloadable, so
    under-counting it makes the offload verdict *more* generous to the
    accelerator — the paper's best-case methodology).  Only categories
    that occurred are keys.
    """
    return count_step(fn, *args, **kwargs).flops
