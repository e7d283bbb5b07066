"""Data-converter (DAC/ADC) cost models — the paper's central object.

The paper (§2, Fig. 2) shows that published DAC (96 designs, Caragiulo &
Murmann survey) and ADC (647 designs, Murmann survey) implementations trade
power against sampling speed along a Pareto frontier, and that analog
accelerator proposals which assume converters far below that frontier
(e.g. the 32x-below-frontier converters needed for the >100,000x optical
MAC energy win of Anderson et al.) are not realizable with known technology.

This module provides:

* ``ConverterSpec`` — a concrete converter design point (bits, rate, power),
  with the Walden figure of merit and per-sample energy/latency derived.
* Reference design points used by the paper: Kim et al. (VLSI'19) DAC and
  Liu et al. (ISSCC'22) ADC — the exact converters Anderson et al. build on.
* ``pareto_fom_fj`` — a survey-envelope model of the best published Walden
  FoM as a function of sampling rate, matching the qualitative shape of the
  Murmann/Caragiulo surveys (flat floor at low speed, degrading above a
  corner frequency).
* ``frontier_gap`` — the feasibility check of §2: how far below the envelope
  a required converter energy sits (>1 means "below the published frontier",
  i.e. does not exist today).

All constants are recorded here rather than imported from the survey CSVs
(offline container); they are calibration targets, not measurements.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "ConverterSpec",
    "KIM_2019_DAC",
    "LIU_2022_ADC",
    "enob_error_bound",
    "pareto_fom_fj",
    "pareto_power_w",
    "frontier_gap",
    "conversion_complexity",
    "CodeSignature",
    "SIGNATURE_FULL_CODE_MAX",
    "quantized_codes",
    "code_signature",
    "expected_flip_fraction",
    "delta_write_scale",
]


def enob_error_bound(enob: float, slack: float = 16.0) -> float:
    """Relative-error budget implied by ``enob`` effective bits.

    A b-bit uniform quantizer on a full-scale signal contributes RMS error
    ~ q / sqrt(12) with q = 1 / (2^b - 1), i.e. a relative L2 error on the
    order of 2^-b; ``slack`` widens that ideal floor to cover detector
    squaring, ADC auto-ranging, and error accumulation across a pipeline.
    ``enob <= 0`` means the converter promises nothing — the budget is
    infinite and no result can violate it.

    Lives here (next to :class:`ConverterSpec`) because both the runtime's
    ``FidelityChecker`` and the planner's fidelity gate consume it — the
    planner must not import from ``repro_torch.runtime``.
    """
    if enob <= 0:
        return math.inf
    return slack * 2.0 ** (-enob)


@dataclasses.dataclass(frozen=True)
class ConverterSpec:
    """A data-converter design point.

    Attributes:
      name: identifier, e.g. ``"kim2019-dac"``.
      kind: ``"dac"`` or ``"adc"``.
      bits: nominal resolution in bits.
      rate_hz: sampling rate (samples/s). For interleaved designs this is the
        aggregate rate.
      power_w: total power at ``rate_hz``.
      enob: effective number of bits (defaults to ``bits - 1.0``, a typical
        published ENOB deficit).
      channels: interleaving factor (informational).
    """

    name: str
    kind: str
    bits: int
    rate_hz: float
    power_w: float
    enob: float | None = None
    channels: int = 1

    def __post_init__(self) -> None:
        if self.kind not in ("dac", "adc"):
            raise ValueError(f"kind must be 'dac' or 'adc', got {self.kind!r}")
        if self.rate_hz <= 0 or self.power_w <= 0 or self.bits <= 0:
            raise ValueError("bits, rate_hz and power_w must be positive")

    @property
    def effective_bits(self) -> float:
        return self.enob if self.enob is not None else self.bits - 1.0

    @property
    def energy_per_sample_j(self) -> float:
        """Energy to convert one sample: P / fs."""
        return self.power_w / self.rate_hz

    @property
    def latency_per_sample_s(self) -> float:
        """Serial conversion latency for one sample: 1 / fs."""
        return 1.0 / self.rate_hz

    @property
    def walden_fom_j(self) -> float:
        """Walden figure of merit: P / (2^ENOB * fs), joules per conv-step."""
        return self.power_w / (2.0 ** self.effective_bits * self.rate_hz)

    def time_for(self, n_samples: int, lanes: int = 1) -> float:
        """Wall time to convert ``n_samples`` with ``lanes`` parallel converters."""
        if lanes < 1:
            raise ValueError("lanes must be >= 1")
        return math.ceil(n_samples / lanes) / self.rate_hz

    def energy_for(self, n_samples: int) -> float:
        """Energy to convert ``n_samples`` (lanes don't change energy/sample)."""
        return n_samples * self.energy_per_sample_j


# --- Reference design points used by the paper (§2) -------------------------
#
# Kim et al., VLSI 2019 [37]: 6 b, 28 GS/s, four-channel time-interleaved
# current-steering DAC. Published power ~ 100 mW class; we record 0.1 W.
KIM_2019_DAC = ConverterSpec(
    name="kim2019-dac", kind="dac", bits=6, rate_hz=28e9, power_w=0.100,
    enob=5.0, channels=4,
)

# Liu et al., ISSCC 2022 [42]: 8 b, 10 GS/s, 25 fJ/conversion-step
# two-step time-domain ADC in 14 nm.  P = FoM * 2^ENOB * fs with ENOB ~ 7:
# 25e-15 * 128 * 10e9 = 32 mW.
LIU_2022_ADC = ConverterSpec(
    name="liu2022-adc", kind="adc", bits=8, rate_hz=10e9, power_w=0.032,
    enob=7.0,
)


# --- Survey-envelope (Pareto frontier) model --------------------------------
#
# Shape taken from the Murmann ADC survey envelope: the best published Walden
# FoM is roughly flat (a few fJ/conv-step) up to a corner rate, then degrades
# about one decade per decade of speed.  The same qualitative shape holds for
# the Caragiulo DAC survey.  Constants below put the Liu ISSCC'22 ADC
# (25 fJ/c-s at 10 GS/s) and the Kim VLSI'19 DAC essentially *on* their
# frontiers, as the paper argues ("above the Pareto frontiers" = realizable,
# while Anderson et al.'s 32x-lower-energy converters sit far below).
_FOM_FLOOR_FJ = {"adc": 2.0, "dac": 4.0}           # fJ / conversion-step
_CORNER_HZ = {"adc": 1.0e8, "dac": 5.0e8}          # envelope corner
_SLOPE = {"adc": 0.55, "dac": 0.83}                # decades FoM per decade fs


def pareto_fom_fj(rate_hz: float, kind: str = "adc") -> float:
    """Best-published Walden FoM (fJ/conv-step) achievable at ``rate_hz``.

    Points *below* this envelope do not exist in the surveys; the paper's
    argument is that analog-accelerator energy claims requiring such points
    (e.g. 32x below) are speculative.
    """
    if kind not in _FOM_FLOOR_FJ:
        raise ValueError(f"kind must be 'dac' or 'adc', got {kind!r}")
    if rate_hz <= 0:
        raise ValueError("rate_hz must be positive")
    floor = _FOM_FLOOR_FJ[kind]
    corner = _CORNER_HZ[kind]
    if rate_hz <= corner:
        return floor
    decades_past = math.log10(rate_hz / corner)
    return floor * 10.0 ** (_SLOPE[kind] * decades_past)


def pareto_power_w(rate_hz: float, bits: float, kind: str = "adc") -> float:
    """Minimum power on the survey envelope for a (rate, resolution) target."""
    fom_j = pareto_fom_fj(rate_hz, kind) * 1e-15
    return fom_j * (2.0 ** bits) * rate_hz


def frontier_gap(spec: ConverterSpec) -> float:
    """How far below the survey envelope a converter sits.

    Returns ``envelope_fom / spec_fom``: 1.0 means on the frontier, >1 means
    the design would need to beat every published design by that factor.
    The paper's headline check: Anderson et al.'s converters need a gap of
    ~32x (``frontier_gap`` >> 1) — see ``benchmarks/pareto.py``.
    """
    envelope = pareto_fom_fj(spec.rate_hz, spec.kind) * 1e-15
    return envelope / spec.walden_fom_j if spec.walden_fom_j > 0 else math.inf


def conversion_complexity(n: int) -> int:
    """The paper's conversion complexity C = 2N (Fig. 3).

    Every datum must cross the boundary twice: DAC on the way in, ADC on the
    way out.
    """
    if n < 0:
        raise ValueError("n must be non-negative")
    return 2 * n


# --- LSB-flip model: delta-encoded DAC writes --------------------------------
#
# Ladder-style DACs (the X2X ladder of Wang et al., JSSC 2022) spend write
# latency/energy on the LSBs that actually CHANGE between consecutive codes,
# not on the full word: rewriting an unchanged operand is near-free, and a
# slowly drifting one costs only its expected flip count.  The functions
# below turn that physics into a ``write_scale`` in (0, 1] the cost models
# apply to the write-side DAC/link terms — the third price between a free
# residency hit and a full re-stage.

# Operands up to this many samples retain their full quantized codes in the
# signature, so the flip fraction is the EXACT mean XOR popcount.  Larger
# operands keep only per-bit-plane popcounts (bits integers per operand) and
# estimate the flip fraction from plane densities.
SIGNATURE_FULL_CODE_MAX = 1 << 16


@dataclasses.dataclass(frozen=True)
class CodeSignature:
    """A cheap summary of an operand's quantized DAC codes.

    ``plane_counts[b]`` is the popcount of bit-plane ``b`` across all ``n``
    codes; ``codes`` holds the full code array for small operands (exact
    flip counting) and ``None`` past :data:`SIGNATURE_FULL_CODE_MAX`.
    """

    bits: int
    n: int
    plane_counts: tuple[int, ...]
    codes: np.ndarray | None = None


def quantized_codes(arr, bits: int) -> np.ndarray:
    """The integer DAC codes ``arr`` quantizes to at ``bits`` resolution.

    Mirrors the runtime's write-path range mapping: an affine map of the
    operand's own [min, max] onto the converter's full scale, rounded to
    the nearest of ``2^bits`` levels.  A constant operand maps to code 0.
    """
    if bits < 1:
        raise ValueError("bits must be >= 1")
    if hasattr(arr, "detach"):  # a torch tensor, possibly on the card
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr, dtype=np.float64).ravel()
    if a.size == 0:
        return np.zeros(0, dtype=np.uint16 if bits <= 16 else np.int64)
    lo = float(a.min())
    span = float(a.max()) - lo
    levels = (1 << bits) - 1
    if span <= 0.0:
        codes = np.zeros(a.shape, dtype=np.int64)
    else:
        codes = np.rint((a - lo) * (levels / span)).astype(np.int64)
    return codes.astype(np.uint16 if bits <= 16 else np.int64)


def code_signature(arr, bits: int, *,
                   full_code_max: int = SIGNATURE_FULL_CODE_MAX,
                   ) -> CodeSignature:
    """Build the :class:`CodeSignature` of ``arr`` at ``bits`` resolution."""
    codes = quantized_codes(arr, bits)
    planes = tuple(int(((codes >> b) & 1).sum()) for b in range(bits))
    keep = codes if codes.size <= full_code_max else None
    return CodeSignature(bits=bits, n=int(codes.size), plane_counts=planes,
                         codes=keep)


def expected_flip_fraction(old: CodeSignature, new: CodeSignature) -> float:
    """Expected fraction of LSBs flipping when ``old``'s staged codes are
    rewritten with ``new``'s, in [0, 1].

    Exact (mean XOR popcount over all bit planes) when both signatures
    retain full codes; otherwise estimated per plane from the densities
    ``p``/``q`` under independence (``p + q - 2pq`` — an upper bound on the
    true per-plane flip rate ``|p - q|``, so the estimate never undercharges
    a correlated drift).  Incomparable signatures (different resolution or
    sample count) are a full rewrite: 1.0.
    """
    if old.bits != new.bits or old.n != new.n or old.n == 0:
        return 1.0
    bits = old.bits
    if old.codes is not None and new.codes is not None:
        x = np.bitwise_xor(old.codes, new.codes)
        flips = sum(int(((x >> b) & 1).sum()) for b in range(bits))
        return flips / (old.n * bits)
    total = 0.0
    for b in range(bits):
        p = old.plane_counts[b] / old.n
        q = new.plane_counts[b] / new.n
        total += p + q - 2.0 * p * q
    return min(1.0, total / bits)


def delta_write_scale(flip_fraction: float, bits: int) -> float:
    """Write-side cost scale for a delta-encoded DAC write: the fraction of
    ladder LSB transitions a partial rewrite performs, floored at ``1/bits``
    (even a bit-identical re-assert strobes one ladder slot per sample, so a
    delta write is never free — only a residency *hit* is)."""
    if bits < 1:
        raise ValueError("bits must be >= 1")
    f = min(max(float(flip_fraction), 0.0), 1.0)
    return min(1.0, max(f, 1.0 / bits))
