"""Device-side operand residency: stop paying the DAC for resident bytes.

The paper's thesis is that conversions — not the analog core — bound
accelerator performance, yet the runtime so far re-stages and re-quantizes
every operand on every flush even when the bytes are unchanged: a conv
layer stack re-sends the same frames once per layer, serving re-sends the
same kernels every decode step.  Real photonic systems exploit exactly the
opposite pattern (weight-stationary MVM: keep one operand resident on the
analog side, stream only the other), and ladder-style DACs make the win
physical — write latency/energy scale with the bits that actually change,
so a resident operand is near-free on the write path.

:class:`ResidencyCache` is that lever, executed:

  * **Content-keyed.**  An entry is keyed by the operand's content digest
    (shape + dtype + SHA1, via ``BackendContext.content_key``) *plus the
    converter operating point* (DAC/ADC bits and ENOB) — retuning a
    converter re-ranges the quantization grid, so every operand staged
    under the old operating point silently stops matching (the resident
    bytes on the device no longer equal what a fresh conversion would
    produce).  Distinct shapes with equal bytes can never collide: the
    shape is part of the digest.
  * **Per-device.**  Resident sets are held per device label (``"host"``
    for the staged-stack path; ``("device", d)`` for sharded placements),
    so a re-scatter ships only the shards missing from each device, and a
    quarantined device's resident set is *dropped* — its bytes are not
    trustworthy after the fault that quarantined it, and re-admission
    must re-stage.  The sharded backend's device-resident placements
    store per-frame shards under kind ``"frame-shard"`` and frame-mode
    row tiles under ``"frame-tile"``; dropping a device's set is what
    invalidates its placement shards.
  * **Budget-priced LRU.**  Capacity is a fraction of the staging
    :class:`~repro_torch.runtime.tiling.MemoryBudget` (residency and tiles
    share the same physical bytes): storing past capacity evicts
    least-recently-used entries, and
    :meth:`ResidencyCache.effective_budget` hands the executor the budget
    *minus* resident bytes so tile depth shrinks as the cache fills.
  * **Observable.**  Every lookup/store/eviction/invalidation is counted
    per category (mirrored into ``RuntimeTelemetry.residency_counts`` and
    emitted as ``cache`` instants on the tracer when either is attached),
    so hit rates are first-class telemetry the router can replan from.

The cache is OPT-IN (``OffloadExecutor(residency=...)``): with it off the
runtime stages exactly as before, bit for bit and price for price.  With
it on, results are still bit-equal to the re-staged path on digital
backends — a hit replays the same computation on the same staged
array — which is how the runtime-equivalence invariant extends to
``cached == re-staged == looped``.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Hashable, Iterable, Sequence

from repro_torch.core.conversion import (code_signature, delta_write_scale,
                                   expected_flip_fraction)

__all__ = ["DELTA_THRESHOLD", "ResidencyCache", "ResidencyEntry",
           "operating_point", "residency_key"]

# Default capacity when no staging budget is supplied (the unlimited-budget
# regime still wants bounded residency: the cache holds live array
# references, and "resident forever" is a leak, not a policy).
DEFAULT_CAPACITY_BYTES = 64 * 1024 * 1024

# Fraction of the staging budget's spendable bytes the cache may pin.  The
# other half stays with tile staging — a cache that ate the whole budget
# would force tile_k to 1 and trade the batching win for the residency win
# instead of keeping both.
BUDGET_FRACTION = 0.5

# Flip fractions at or below this classify a re-staged operand as a
# *delta* write (partial price); above it the rewrite is effectively a new
# operand and pays the full write.  Uncorrelated frames flip ~50% of their
# LSBs, a drifting sensor frame far fewer — 0.35 splits those regimes with
# margin on both sides.
DELTA_THRESHOLD = 0.35

# Per-operand slot signatures retained for delta classification.  The
# ledger is keyed by dispatch slot, not content, so it grows with distinct
# (stream, category, shape, index) shapes — past this it resets wholesale
# (conservative: forgotten slots re-stage in full, never mis-price).
SLOT_LEDGER_MAX = 4096


def operating_point(spec) -> tuple:
    """The converter operating point residency keys must carry.

    Bits AND effective bits (ENOB) on both paths: retuning either
    converter moves the quantization grid, so bytes staged under the old
    point are stale even though the digital source operand is unchanged.
    """
    return ("op", spec.dac.bits, float(spec.dac.effective_bits),
            spec.adc.bits, float(spec.adc.effective_bits))


def residency_key(ctx, xs: Sequence, kind: str) -> tuple:
    """Residency key for an operand group: kind + operating point + the
    per-item content digests (shape, dtype, SHA1 — via the context's
    id-memoized ``content_key``, so repeat flushes of long-lived arrays
    never re-hash)."""
    return (kind, operating_point(ctx.spec),
            tuple(ctx.content_key(x) for x in xs))


@dataclasses.dataclass
class ResidencyEntry:
    """One resident operand: the staged payload and its accounting."""

    device: Hashable
    key: tuple
    payload: object
    nbytes: int
    category: str
    kind: str  # "frame" (staged stack) / "kernel" / "weights" / "shard"


class ResidencyCache:
    """Content-keyed per-device operand residency under the staging budget.

    Args:
      budget: the staging :class:`~repro_torch.runtime.tiling.MemoryBudget` the
        cache shares bytes with.  Capacity is ``BUDGET_FRACTION`` of its
        spendable bytes; an unlimited (or absent) budget falls back to
        :data:`DEFAULT_CAPACITY_BYTES`.
      capacity_bytes: explicit capacity override (wins over ``budget``).
      fraction: the budget share when deriving capacity from ``budget``.
      delta_threshold: flip fraction at or below which a changed operand
        re-staged into a known dispatch slot takes the delta-encoded
        partial write instead of a full re-stage
        (:data:`DELTA_THRESHOLD`).
    """

    def __init__(self, budget=None, *, capacity_bytes: int | None = None,
                 fraction: float = BUDGET_FRACTION,
                 delta_threshold: float = DELTA_THRESHOLD) -> None:
        if capacity_bytes is not None:
            cap = int(capacity_bytes)
        elif budget is not None and not budget.is_unlimited:
            cap = int(budget.spendable_bytes * fraction)
        else:
            cap = DEFAULT_CAPACITY_BYTES
        self.capacity_bytes = max(1, cap)
        # one global LRU order across devices: the budget is a per-host
        # staging pool, so the coldest entry anywhere is the right victim
        self._lru: "collections.OrderedDict[tuple, ResidencyEntry]" = \
            collections.OrderedDict()
        self._bytes = 0
        # category -> Counter of "hit"/"miss"/"eviction"/"invalidation"
        self.counts: dict[str, collections.Counter] = \
            collections.defaultdict(collections.Counter)
        # submit(reuse=) tokens: token -> ((shape, dtype), content key)
        self._tokens: dict[str, tuple] = {}
        # delta classification: dispatch slot -> (content key, signature)
        # of the operand last staged into that slot — the "previously
        # staged codes" a partial rewrite is diffed against
        self.delta_threshold = float(delta_threshold)
        self._slots: dict[tuple, tuple] = {}

    # -- events (cache-local counters + telemetry/tracer mirror) -------------
    def _emit(self, ctx, category: str, event: str, **attrs) -> None:
        self.counts[category][event] += 1
        if ctx is None:
            return
        tel = getattr(ctx, "telemetry", None)
        note = getattr(tel, "note_residency", None)
        if note is not None:
            note(category, event)
        tr = getattr(ctx, "tracer", None)
        if tr is not None:
            tr.instant("cache", lane="host", category=category, event=event,
                       **attrs)

    # -- the cache proper ------------------------------------------------------
    def lookup(self, device: Hashable, key: tuple, *, category: str,
               ctx=None):
        """The resident payload for ``(device, key)``, or None on a miss.
        A hit refreshes the entry's LRU position."""
        entry = self._lru.get((device, key))
        if entry is None:
            self._emit(ctx, category, "miss", device=str(device))
            return None
        self._lru.move_to_end((device, key))
        self._emit(ctx, category, "hit", device=str(device),
                   kind=entry.kind, nbytes=entry.nbytes)
        return entry.payload

    def store(self, device: Hashable, key: tuple, payload, nbytes: int, *,
              category: str, kind: str, ctx=None) -> list[ResidencyEntry]:
        """Insert one resident operand, evicting LRU entries past capacity.

        Returns the evicted entries (empty when none).  An operand larger
        than the whole capacity is not cached at all — evicting everything
        to hold one entry would thrash the working set it shares the
        budget with."""
        nbytes = max(0, int(nbytes))
        if nbytes > self.capacity_bytes:
            return []
        old = self._lru.pop((device, key), None)
        if old is not None:
            self._bytes -= old.nbytes
        evicted: list[ResidencyEntry] = []
        while self._lru and self._bytes + nbytes > self.capacity_bytes:
            _, victim = self._lru.popitem(last=False)
            self._bytes -= victim.nbytes
            evicted.append(victim)
            self._emit(ctx, victim.category, "eviction",
                       device=str(victim.device), kind=victim.kind,
                       nbytes=victim.nbytes)
        entry = ResidencyEntry(device=device, key=key, payload=payload,
                               nbytes=nbytes, category=category, kind=kind)
        self._lru[(device, key)] = entry
        self._bytes += nbytes
        return evicted

    def classify_operand(self, slot_key: tuple, ck: tuple, x, spec, *,
                         category: str, ctx=None) -> tuple[str, float]:
        """Classify one operand re-staged into dispatch slot ``slot_key``
        as ``("hit", 0.0)`` / ``("delta", write_scale)`` /
        ``("full", 1.0)`` against the operand last staged there.

        ``ck`` is the operand's content key (already computed by the
        caller — the slot comparison is digest-equality, so an unchanged
        operand never pays the signature).  A changed operand pays one
        :func:`~repro_torch.core.conversion.code_signature` at the DAC's
        resolution; its flip fraction against the slot's previous
        signature decides delta (≤ ``delta_threshold``, priced at
        :func:`~repro_torch.core.conversion.delta_write_scale`) versus full.
        Every outcome updates the slot ledger; delta/full writes are
        mirrored into ``RuntimeTelemetry.delta_stats`` when the context
        carries telemetry.  Classification never touches the LRU — it is
        the *write-side* price of an operand the group-grain lookup
        already missed."""
        prev = self._slots.get(slot_key)
        if prev is not None and prev[0] == ck:
            return "hit", 0.0
        bits = spec.dac.bits
        sig = code_signature(x, bits)
        if slot_key not in self._slots and len(self._slots) >= SLOT_LEDGER_MAX:
            self._slots.clear()
        self._slots[slot_key] = (ck, sig)
        tel = getattr(ctx, "telemetry", None) if ctx is not None else None
        note = getattr(tel, "note_delta", None)
        if prev is None:
            if note is not None:
                note(category)
            return "full", 1.0
        frac = expected_flip_fraction(prev[1], sig)
        if frac > self.delta_threshold:
            if note is not None:
                note(category)
            return "full", 1.0
        self._emit(ctx, category, "delta", flip=frac)
        if note is not None:
            note(category, flip_fraction=frac)
        return "delta", delta_write_scale(frac, bits)

    def discard(self, device: Hashable, key: tuple, *, ctx=None,
                reason: str = "donation") -> int:
        """Drop one resident entry outright (buffer donation: a placed
        frame about to be re-staged donates its stale device buffer so
        the update never holds two copies against the staging budget).
        Returns the bytes freed, 0 when the entry was not resident."""
        entry = self._lru.pop((device, key), None)
        if entry is None:
            return 0
        self._bytes -= entry.nbytes
        self._emit(ctx, entry.category, reason, device=str(device),
                   kind=entry.kind, nbytes=entry.nbytes)
        return entry.nbytes

    def invalidate_device(self, device: Hashable, *, ctx=None) -> int:
        """Drop ``device``'s whole resident set (fault quarantine: the
        bytes on a device that just faulted are not trustworthy, and
        re-admission must re-stage).  Returns bytes dropped."""
        doomed = [k for k in self._lru if k[0] == device]
        dropped = 0
        for k in doomed:
            entry = self._lru.pop(k)
            self._bytes -= entry.nbytes
            dropped += entry.nbytes
            self._emit(ctx, entry.category, "invalidation",
                       device=str(device), kind=entry.kind,
                       nbytes=entry.nbytes)
        # the device's slot signatures go too: delta-diffing against codes
        # staged on a quarantined device would price a partial write the
        # hardware cannot be trusted to hold
        for sk in [s for s in self._slots if s and s[0] == device]:
            del self._slots[sk]
        return dropped

    def clear(self) -> None:
        """Drop every entry (counters and tokens survive — they are the
        run's ledger, not the cache's contents)."""
        self._lru.clear()
        self._bytes = 0
        self._slots.clear()

    # -- views -----------------------------------------------------------------
    def resident_bytes(self, device: Hashable | None = None) -> int:
        if device is None:
            return self._bytes
        return sum(e.nbytes for (d, _k), e in self._lru.items()
                   if d == device)

    def resident_keys(self, device: Hashable | None = None,
                      ) -> Iterable[tuple]:
        return [k for (d, k) in self._lru if device is None or d == device]

    def __len__(self) -> int:
        return len(self._lru)

    def hit_rate(self, category: str | None = None) -> float | None:
        """hits / (hits + misses) for ``category`` (overall when None);
        None before any lookup — no traffic is no claim."""
        hits = misses = 0
        for cat, c in self.counts.items():
            if category is not None and cat != category:
                continue
            hits += c.get("hit", 0)
            misses += c.get("miss", 0)
        total = hits + misses
        return None if total == 0 else hits / total

    # -- budget sharing --------------------------------------------------------
    def effective_budget(self, budget):
        """The staging budget left after the cache's resident bytes: tiles
        and residency share the same physical pool, so a fuller cache
        means a shallower tile (``MemoryBudget.minus``)."""
        if budget is None:
            return budget
        return budget.minus(self.resident_bytes())

    # -- submit(reuse=) tokens -------------------------------------------------
    def note_token(self, token: str, x, ctx) -> tuple:
        """Register (or re-assert) a reuse token for operand ``x``.

        The explicit-token path of ``OffloadExecutor.submit(reuse=...)``:
        the caller promises that every submission under ``token`` carries
        the same content, so after the first digest the token's key is
        seeded straight into the context's digest memo and later
        submissions never re-hash.  A token re-used with a different
        shape/dtype is treated as a new operand (re-digested, token
        re-bound) rather than trusted."""
        sig = (tuple(x.shape), str(x.dtype))
        rec = self._tokens.get(token)
        if rec is not None and rec[0] == sig:
            # trust the token: seed the memo so content_key(x) is free
            ctx._digest_memo[id(x)] = (x, getattr(x, "_version", None),
                                       rec[1])
            return rec[1]
        key = ctx.content_key(x)
        self._tokens[token] = (sig, key)
        return key

    def summary(self) -> str:
        rows = [f"residency: {len(self._lru)} entries, "
                f"{self._bytes}/{self.capacity_bytes} bytes"]
        for cat, c in sorted(self.counts.items()):
            parts = [f"{k} x{v}" for k, v in sorted(c.items())]
            rate = self.hit_rate(cat)
            row = f"  {cat}: " + "; ".join(parts)
            if rate is not None:
                row += f" (hit rate {rate:.0%})"
            rows.append(row)
        return "\n".join(rows)
