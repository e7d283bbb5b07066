"""Analog accelerator specifications and end-to-end step cost models.

The paper's Fig. 7a architecture: a digital host talks to an analog optical
engine through (i) a DAC + spatial-light-modulator write path and (ii) a
camera detector + ADC read path.  The analog compute itself (diffraction)
runs at the speed of light; everything else is the data-conversion /
data-movement boundary that this paper identifies as the bottleneck.

Two accelerator families are modeled:

* ``OpticalFourierAcceleratorSpec`` — the paper's own 4f Fourier/convolution
  engine (Appendix A/B).
* ``OpticalMVMAcceleratorSpec`` — the optical matrix-vector-multiply engine
  of Anderson et al. that the paper's §2 critique targets; included so the
  offload planner can evaluate the "more promising" MVM target (§5.1) under
  honest conversion costs.

Cost model conventions: times in seconds, energies in joules, ``n`` counts
scalar samples crossing the conversion boundary.  ``step_cost`` prices one
serial invocation; ``batched_step_cost`` prices one invocation carrying a
coalesced batch (fixed per-frame costs amortize), and its
``pipeline_depth >= 2`` mode prices *double-buffered* execution where the
write path of frame f+1 overlaps the analog+read path of frame f — the
steady-state boundary cost becomes max(write, analog+read) per stage
instead of their sum (see the method docstrings for the exact accounting).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.conversion import ConverterSpec, KIM_2019_DAC, LIU_2022_ADC

__all__ = [
    "StepCost",
    "OpticalFourierAcceleratorSpec",
    "OpticalMVMAcceleratorSpec",
    "PROTOTYPE_4F",
    "IDEAL_4F",
    "ANDERSON_MVM",
    "SPEED_OF_LIGHT_M_S",
    "tile_sizes",
]

SPEED_OF_LIGHT_M_S = 299_792_458.0


def tile_sizes(k: int, tile_k: int) -> list[int]:
    """Sub-invocation sizes for a K-deep group at ``tile_k`` frames/tile:
    ``ceil(k / tile_k)`` tiles, the last one ragged when ``tile_k`` does
    not divide ``k``.  The ONE definition of the split — the runtime's
    dispatcher/warmer (via ``repro_torch.runtime.tiling``) and both cost models
    below share it, so the modeled tile stream can never desync from the
    dispatched one."""
    if k < 1:
        raise ValueError("k must be >= 1")
    tile_k = max(1, min(int(tile_k), k))
    sizes = [tile_k] * (k // tile_k)
    if k % tile_k:
        sizes.append(k % tile_k)
    return sizes


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Cost breakdown for one accelerator invocation (the Fig. 8 split)."""

    dac_s: float
    adc_s: float
    interface_s: float      # host<->peripheral link (SLM write + camera read)
    analog_s: float         # the physics (time of flight / settle / exposure)
    host_s: float = 0.0     # digital post-processing (e.g. the host iFFT)
    hold_s: float = 0.0     # queueing delay: how long the batch was held
                            # open accumulating occupancy before dispatch

    @property
    def total_s(self) -> float:
        return (self.dac_s + self.adc_s + self.interface_s + self.analog_s
                + self.host_s + self.hold_s)

    @property
    def conversion_s(self) -> float:
        return self.dac_s + self.adc_s

    @property
    def data_movement_fraction(self) -> float:
        """Fraction of wall time spent moving/converting data (paper: 99.599%).

        Hold time is queueing, not movement: it sits in neither the
        numerator nor this fraction's story, but it does stretch
        ``total_s`` — an invocation that waited for its batch is slower
        end to end, honestly."""
        tot = self.total_s
        if tot <= 0:
            return 0.0
        return (self.dac_s + self.adc_s + self.interface_s) / tot

    def scaled(self, k: float) -> "StepCost":
        return StepCost(self.dac_s * k, self.adc_s * k, self.interface_s * k,
                        self.analog_s * k, self.host_s * k, self.hold_s * k)

    def __add__(self, other: "StepCost") -> "StepCost":
        if not isinstance(other, StepCost):
            return NotImplemented
        return StepCost(self.dac_s + other.dac_s, self.adc_s + other.adc_s,
                        self.interface_s + other.interface_s,
                        self.analog_s + other.analog_s,
                        self.host_s + other.host_s,
                        self.hold_s + other.hold_s)


def _compose_sides(sides: dict, *, host_s: float = 0.0,
                   hold_s: float = 0.0) -> StepCost:
    """Collapse per-engine side tuples ``(dac_s, adc_s, intf_in, intf_out,
    analog_s, serial_s, stages)`` into one pipelined :class:`StepCost`.

    The executor's per-engine windows share one host staging/DAC write
    path but each engine owns its analog core and readout, so the composed
    wall is ``max(sum of write sides, slowest engine's read side)``: the
    binding side is kept whole and every hidden side is charged only its
    exposed ``1/total_stages`` prologue share — the same convention the
    single-engine ``pipeline_depth`` collapse uses, applied across
    engines.  Serial components (handshakes whose split is unknown, sync
    barriers) never overlap.
    """
    writes = {n: s[0] + s[2] for n, s in sides.items()}
    reads = {n: s[1] + s[3] + s[4] for n, s in sides.items()}
    serial = sum(s[5] for s in sides.values())
    total_stages = sum(s[6] for s in sides.values())
    w_total = sum(writes.values())
    r_name = max(reads, key=lambda n: reads[n])
    r_max = reads[r_name]
    dac_s = adc_s = intf_in = intf_out = analog_s = 0.0
    hidden = 1.0 / total_stages if total_stages > 1 else 1.0
    for name, (d, a, i1, i2, an, _sy, _st) in sides.items():
        if total_stages > 1:
            if w_total >= r_max:
                # the shared host write path binds: every engine's
                # analog+read side hides behind it
                a *= hidden
                i2 *= hidden
                an *= hidden
            elif name == r_name:
                # the slowest engine's read side binds: its own write
                # prologue is the only exposed write share
                d *= hidden
                i1 *= hidden
            else:
                d *= hidden
                a *= hidden
                i1 *= hidden
                i2 *= hidden
                an *= hidden
        dac_s += d
        adc_s += a
        intf_in += i1
        intf_out += i2
        analog_s += an
    return StepCost(dac_s=dac_s, adc_s=adc_s,
                    interface_s=intf_in + intf_out + serial,
                    analog_s=analog_s, host_s=host_s, hold_s=hold_s)


@dataclasses.dataclass(frozen=True)
class OpticalFourierAcceleratorSpec:
    """A 4f optical Fourier/convolution accelerator (paper Appendix A/B).

    Attributes:
      name: identifier.
      slm_pixels: (rows, cols) of the programmable aperture.
      dac / adc: converter design points on the write/read paths.
      dac_lanes / adc_lanes: parallel converter lanes (column-parallel
        readout in modern image sensors; 1 for the serial prototype).
      slm_interface_hz: pixel-write rate of the peripheral link into the SLM
        local memory (the paper's prototype uses a 60 Hz-display-class link).
      camera_interface_hz: pixel-read rate of the camera link.
      slm_settle_s: liquid-crystal settle time per frame.
      exposure_s: detector integration time per frame.
      path_length_m: optical path (4f => 4 * focal_length).
      macro_pixel: aggregation factor per axis for crosstalk mitigation
        (Anderson et al. aggregate 3x3 -> macro_pixel=3, costing 9x pixels).
      phase_shift_captures: captures per result; 1 = magnitude-only detector,
        4 = four-step phase-shifting interferometry (complex recovery).
      interface_latency_s: fixed host<->peripheral round-trip latency charged
        once per accelerator invocation (link handshake / frame sync — e.g.
        one 60 Hz display frame period for the prototype's USB/DSI links).
        This is the term batching amortizes (§6); 0 preserves the paper's
        throughput-only calibration.
      device_sync_s: per-device synchronization epsilon for multi-aperture
        (sharded) execution: when one invocation is scattered across
        ``n_devices`` replicated accelerators, the host pays this barrier
        cost once per participating device on top of the slowest device's
        boundary crossing (see ``batched_step_cost(n_devices=...)``).
    """

    name: str
    slm_pixels: tuple[int, int] = (1024, 768)
    dac: ConverterSpec = KIM_2019_DAC
    adc: ConverterSpec = LIU_2022_ADC
    dac_lanes: int = 1
    adc_lanes: int = 1
    slm_interface_hz: float = 1.0e6
    camera_interface_hz: float = 1.0e6
    slm_settle_s: float = 1.0e-3
    exposure_s: float = 1.0e-3
    path_length_m: float = 0.5
    macro_pixel: int = 1
    phase_shift_captures: int = 1
    interface_latency_s: float = 0.0
    device_sync_s: float = 0.0

    @property
    def usable_pixels(self) -> int:
        r, c = self.slm_pixels
        return (r // self.macro_pixel) * (c // self.macro_pixel)

    def time_of_flight_s(self) -> float:
        return self.path_length_m / SPEED_OF_LIGHT_M_S

    def step_cost(self, n_in: int, n_out: int | None = None,
                  host_s: float = 0.0) -> StepCost:
        """Cost of one accelerated op moving ``n_in`` samples in, ``n_out`` out.

        The conversion complexity is the paper's C = 2N (Fig. 3) when
        n_out == n_in.  Every capture repeats the read path
        (``phase_shift_captures`` of them) but the write path is programmed
        once per input.
        """
        if n_out is None:
            n_out = n_in
        caps = self.phase_shift_captures
        dac_s = self.dac.time_for(n_in, self.dac_lanes)
        adc_s = self.adc.time_for(n_out, self.adc_lanes) * caps
        interface_s = (n_in / self.slm_interface_hz
                       + caps * n_out / self.camera_interface_hz
                       + self.interface_latency_s)
        analog_s = (self.slm_settle_s + self.exposure_s) * caps + self.time_of_flight_s()
        return StepCost(dac_s=dac_s, adc_s=adc_s, interface_s=interface_s,
                        analog_s=analog_s, host_s=host_s)

    def _batched_sides(self, n_in: int, n_out: int, batch: int,
                       write_batch: int | None = None,
                       write_scale: float = 1.0,
                       ) -> tuple[float, float, float, float, float, int]:
        """Unoverlapped resource totals of ONE invocation carrying
        ``batch`` inputs on one device: (dac_s, adc_s, intf_in, intf_out,
        analog_s, frames).  The write side is dac + intf_in; the
        analog+read side is adc + intf_out + analog.  Shared by the
        monolithic, tiled, and sharded pricing paths so all three charge
        identical per-invocation physics.

        ``write_batch`` (default: ``batch``) is how many of the inputs
        actually cross the write path this invocation — the rest are
        *resident* on the device from an earlier staging, so they pay no
        DAC conversion, no SLM link transfer, and no write-side frame
        handshake.  The read side always prices the full ``batch``: every
        result still crosses the detector + ADC.

        ``write_scale`` (default 1.0) scales the per-sample write terms —
        DAC conversion and SLM link transfer — for *delta-encoded* writes:
        an X2X-ladder DAC rewriting a staged operand pays only for the
        LSBs that flip, so a low-delta write crosses a fraction of the
        write path.  The per-frame handshake stays whole (the frame sync
        does not shrink with the payload)."""
        caps = self.phase_shift_captures
        px = max(self.usable_pixels, 1)
        frames = max(1, math.ceil(batch * n_in / px))
        wb = batch if write_batch is None else max(0, min(write_batch, batch))
        wframes = frames if wb == batch \
            else math.ceil(wb * n_in / px)
        dac_s = self.dac.time_for(wb * n_in, self.dac_lanes) if wb else 0.0
        adc_s = self.adc.time_for(batch * n_out, self.adc_lanes) * caps
        link_in = wb * n_in / self.slm_interface_hz
        if write_scale != 1.0:
            dac_s *= write_scale
            link_in *= write_scale
        intf_in = link_in + wframes * self.interface_latency_s
        intf_out = caps * batch * n_out / self.camera_interface_hz
        analog_s = (frames * (self.slm_settle_s + self.exposure_s) * caps
                    + self.time_of_flight_s())
        return dac_s, adc_s, intf_in, intf_out, analog_s, frames

    def _group_sides(self, n_in: int, n_out: int | None, *, batch: int,
                     pipeline_depth: int, n_devices: int,
                     tile_k: int | None, mem_budget,
                     resident_frames: int, weight_samples: int,
                     resident_weights: int,
                     delta_fractions: tuple = (),
                     ) -> tuple[float, float, float, float, float, float,
                                int]:
        """Unoverlapped totals of one (possibly tiled, sharded, partially
        resident) invocation: ``(dac_s, adc_s, intf_in, intf_out, analog_s,
        sync_s, stages)``.  This is the accounting both
        :meth:`batched_step_cost` (which then applies the intra-invocation
        pipeline collapse) and the ``engines=`` composition mode (which
        applies a cross-engine collapse instead) price from — one
        definition of the physics, two overlap disciplines.

        ``delta_fractions`` are per-frame write scales in (0, 1] for the
        *delta-staged* subset of the written frames: frame order within
        each tile is resident → delta → full, so the tile's written share
        crosses the write path at the mean of its delta scales (full
        writes count 1.0).  ``resident_frames + len(delta_fractions)``
        must not exceed ``batch``."""
        if n_out is None:
            n_out = n_in
        if batch < 1:
            raise ValueError("batch must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if resident_frames < 0 or weight_samples < 0 or resident_weights < 0:
            raise ValueError("residency counts must be >= 0")
        deltas = tuple(float(f) for f in delta_fractions)
        for f in deltas:
            if not 0.0 < f <= 1.0:
                raise ValueError("delta fractions must be in (0, 1]")
        if len(deltas) + min(int(resident_frames), batch) > batch:
            raise ValueError(
                "resident_frames + len(delta_fractions) exceeds batch")
        if tile_k is None and mem_budget is not None:
            tile_k = mem_budget.tile_for_group(
                n_in, n_out, batch, pipeline_depth=pipeline_depth)
        if tile_k is not None and tile_k < 1:
            raise ValueError("tile_k must be >= 1")
        sizes = tile_sizes(batch, batch if tile_k is None else tile_k)
        dac_s = adc_s = intf_in = intf_out = analog_s = sync_s = 0.0
        stages = 0
        remaining = min(int(resident_frames), batch)
        di = 0
        for b in sizes:
            eff = min(n_devices, b)
            pb = math.ceil(b / eff)
            res_b = min(remaining, b)
            remaining -= res_b
            # the tile's non-resident share crosses the write path, split
            # per device the same way the frames themselves are
            wb = pb - min(math.ceil(res_b / eff), pb)
            written = b - res_b
            take = min(len(deltas) - di, written)
            if take > 0 and written:
                tile_deltas = deltas[di:di + take]
                di += take
                ws = (math.fsum(tile_deltas) + (written - take)) / written
            else:
                ws = 1.0
            d, a, i1, i2, an, fr = self._batched_sides(
                n_in, n_out, pb, write_batch=wb, write_scale=ws)
            dac_s += d
            adc_s += a
            intf_in += i1
            intf_out += i2
            analog_s += an
            stages += fr
            if n_devices > 1:
                sync_s += eff * self.device_sync_s
        w_extra = max(0, int(weight_samples) - int(resident_weights))
        if w_extra:
            dac_s += self.dac.time_for(w_extra, self.dac_lanes)
            intf_in += w_extra / self.slm_interface_hz
        # the stages slot counts OVERLAPPABLE stages: a strictly serial
        # engine (pipeline_depth 1) exposes every prologue whole, so it
        # must compose as a single stage — this is what keeps a
        # degenerate one-engine composition exactly equal to the
        # pipeline_depth price at every depth
        if pipeline_depth < 2:
            stages = 1
        return dac_s, adc_s, intf_in, intf_out, analog_s, sync_s, stages

    def _compose_engines(self, engines, *, host_s: float = 0.0,
                         hold_s: float = 0.0) -> StepCost:
        """Price concurrent per-engine pipeline windows (the executor's
        DAG mode): each engine's write path (DAC + SLM link) serializes on
        the shared host staging resource while the analog+read paths run
        concurrently on their own hardware, so the composed wall is
        ``max(sum of write sides, slowest engine's read side)`` with the
        hidden sides charged only their exposed 1/stages prologue share —
        the same keep-the-binding-side-whole convention the
        ``pipeline_depth`` mode uses, applied across engines."""
        if not engines:
            raise ValueError("engines must name at least one engine")
        sides: dict = {}
        for name, e in engines.items():
            if isinstance(e, StepCost):
                # pre-priced engine: write = DAC, read = ADC + analog, the
                # interface split is unknown so it stays serial
                sides[name] = (e.dac_s, e.adc_s, 0.0, 0.0, e.analog_s,
                               e.interface_s, 1)
                continue
            kw = dict(e)
            sides[name] = self._group_sides(
                kw.pop("n_in"), kw.pop("n_out", None),
                batch=kw.pop("batch", 1),
                pipeline_depth=kw.pop("pipeline_depth", 1),
                n_devices=kw.pop("n_devices", 1),
                tile_k=kw.pop("tile_k", None),
                mem_budget=kw.pop("mem_budget", None),
                resident_frames=kw.pop("resident_frames", 0),
                weight_samples=kw.pop("weight_samples", 0),
                resident_weights=kw.pop("resident_weights", 0),
                delta_fractions=kw.pop("delta_fractions", ()))
            if kw:
                raise ValueError(f"unknown engine kwargs for {name!r}: "
                                 f"{sorted(kw)}")
        return _compose_sides(sides, host_s=host_s, hold_s=hold_s)

    def batched_step_cost(self, n_in: int, n_out: int | None = None, *,
                          batch: int = 1, host_s: float = 0.0,
                          pipeline_depth: int = 1,
                          n_devices: int = 1,
                          hold_s: float = 0.0,
                          tile_k: int | None = None,
                          mem_budget=None,
                          resident_frames: int = 0,
                          weight_samples: int = 0,
                          resident_weights: int = 0,
                          delta_fractions: tuple = (),
                          engines=None) -> StepCost:
        """Cost of one invocation carrying ``batch`` same-shape inputs.

        ``hold_s`` is the queueing delay a continuous-batching scheduler
        spent holding this group open to accumulate occupancy (age of the
        oldest coalesced call at dispatch).  It is charged whole to the
        invocation's wall clock — amortization bought by waiting is only a
        win when the handshake savings exceed the wait, and pricing the
        wait is what keeps that trade honest.

        The batch is packed spatially onto the aperture (the runtime's §6
        amortization lever): the converters still touch every sample
        (conversion stays C = 2N per datum), but the fixed per-invocation
        costs — link handshake latency, SLM settle, exposure — are charged
        once per *frame* instead of once per call, and lane-parallel
        converters amortize their ceil() residue across the whole batch.
        ``batch=1`` reproduces :meth:`step_cost` exactly whenever the input
        fits one frame.

        ``pipeline_depth >= 2`` additionally models *double-buffered* frame
        streaming (the runtime executor's async flush): while frame f is
        settling, exposing, and reading out through the ADC, the DAC + SLM
        link are already writing frame f+1 into the second buffer.  The two
        resources — the write path (DAC, SLM link, frame handshake) and the
        analog+read path (settle, exposure, ADC, camera link) — then run
        concurrently, so each steady-state stage costs
        ``max(write_path, analog + read_path)`` instead of their *sum*; only
        the first write and the last read stick out of the overlap.  The
        returned :class:`StepCost` keeps the slower side whole and charges
        the faster (hidden) side only its exposed 1/stages prologue share,
        so ``total_s`` equals the pipelined wall clock while the breakdown
        still says which side bounds throughput.  With a single frame there
        is nothing to overlap and the depth is ignored.

        ``n_devices >= 2`` prices *multi-aperture* (sharded) execution —
        how photonic systems actually scale: replicate apertures rather
        than grow one.  The batch scatters across ``n_devices`` replicated
        accelerators, each carrying ``ceil(batch / n_devices)`` inputs
        through its OWN converters and links (per-invocation fixed costs do
        NOT amortize across devices — every device pays its own handshake,
        settle, and exposure).  The devices run concurrently, so the wall
        cost is the slowest (largest) shard's cost — max-over-devices —
        plus one ``device_sync_s`` of barrier overhead per *participating*
        device charged to the interface (a group shallower than the fleet
        occupies only ``batch`` devices, matching the runtime's
        ``shard_sizes`` split).

        ``tile_k`` prices *memory-budgeted tiled dispatch* (the runtime's
        ``choose_tile`` lever): the batch streams as ``ceil(batch /
        tile_k)`` sub-invocations of at most ``tile_k`` inputs each —
        exactly how the executor dispatches a group whose monolithic stack
        would overflow the staging budget.  Every tile pays its OWN
        per-invocation prologue (frame handshake, settle, exposure,
        time-of-flight; under sharding, each tile scatters across the
        devices and re-pays the sync barrier), but with ``pipeline_depth
        >= 2`` consecutive tiles overlap through the executor's two-deep
        async pipeline — tile t+1's write path behind tile t's analog+read
        — so the steady-state wall is max-side over the whole tile stream,
        with the faster side charged only its exposed prologue share.
        ``tile_k >= batch`` is exactly the monolithic price; ``tile_k=1``
        prices the looped regime.  Alternatively pass ``mem_budget`` (any
        object with a ``tile_for_group(n_in, n_out, k, pipeline_depth=...)``
        method, e.g. ``repro_torch.runtime.tiling.MemoryBudget``) and the tile
        depth is derived from the byte budget exactly as the executor
        derives it — same frame cap, same even-split divisor refinement.

        ``resident_frames`` prices *operand residency* (the runtime's
        ``ResidencyCache``): that many of the batch's inputs are already
        staged on the device from an earlier invocation, so they skip the
        whole write side — no DAC conversion, no SLM link transfer, no
        write-side frame handshake — while the read side still prices the
        full batch (every result crosses the detector + ADC).  A fully
        resident batch therefore costs ``dac_s == 0``: a hit is
        read-side-only, which is exactly what the dispatcher does with a
        residency hit.  ``weight_samples`` is the kernel/weight operand's
        sample count written to the Fourier-plane SLM this invocation
        (charged once, on the write side), and ``resident_weights`` the
        subset of those samples already resident — a resident kernel
        writes nothing.  All three default to 0: the historical price,
        bit for bit.

        ``delta_fractions`` prices *delta-encoded* staging (the residency
        cache's third price between free hit and full re-stage): each
        entry is the write scale in (0, 1] of one written frame whose
        staged codes differ from the new operand by only that fraction of
        LSB flips — an X2X-ladder DAC pays for flipped LSBs, not whole
        words.  Delta frames scale the per-sample write terms (DAC
        conversion, SLM link transfer) while the frame handshake and the
        entire read side stay whole, so the price is guaranteed to land
        between the residency-hit price (``delta_fractions`` can never
        reach 0) and the full-write price (scales cap at 1.0).
        ``resident_frames + len(delta_fractions)`` must not exceed
        ``batch``; the default empty tuple reproduces the historical
        price bit for bit.

        ``engines`` switches to the *composition* mode pricing the
        executor's per-engine pipeline windows: a mapping of engine name →
        either a kwargs dict for this method (``n_in`` required, same
        levers as above minus ``engines`` itself) or a pre-priced
        :class:`StepCost`.  All other keyword levers are ignored in this
        mode except ``host_s``/``hold_s`` — see :meth:`_compose_engines`
        for the overlap discipline.
        """
        if engines is not None:
            return self._compose_engines(engines, host_s=host_s,
                                         hold_s=hold_s)
        dac_s, adc_s, intf_in, intf_out, analog_s, sync_s, stages = (
            self._group_sides(n_in, n_out, batch=batch,
                              pipeline_depth=pipeline_depth,
                              n_devices=n_devices, tile_k=tile_k,
                              mem_budget=mem_budget,
                              resident_frames=resident_frames,
                              weight_samples=weight_samples,
                              resident_weights=resident_weights,
                              delta_fractions=delta_fractions))
        if pipeline_depth >= 2 and stages > 1:
            write_side = dac_s + intf_in
            read_side = adc_s + intf_out + analog_s
            hidden = 1.0 / stages  # exposed prologue share of the faster side
            if write_side <= read_side:
                dac_s *= hidden
                intf_in *= hidden
            else:
                adc_s *= hidden
                intf_out *= hidden
                analog_s *= hidden
        return StepCost(dac_s=dac_s, adc_s=adc_s,
                        interface_s=intf_in + intf_out + sync_s,
                        analog_s=analog_s, host_s=host_s, hold_s=hold_s)

    def step_energy_j(self, n_in: int, n_out: int | None = None) -> float:
        if n_out is None:
            n_out = n_in
        return (self.dac.energy_for(n_in)
                + self.adc.energy_for(n_out) * self.phase_shift_captures)


@dataclasses.dataclass(frozen=True)
class OpticalMVMAcceleratorSpec:
    """An optical matrix-vector multiply engine (Anderson et al. class).

    Weights are assumed held in the optical domain (amortized); activations
    cross the conversion boundary every pass: DAC in, ADC out.  One pass
    computes ``rows x cols`` MACs.
    """

    name: str
    rows: int = 512
    cols: int = 512
    dac: ConverterSpec = KIM_2019_DAC
    adc: ConverterSpec = LIU_2022_ADC
    dac_lanes: int = 512          # wavelength/space multiplexed input lanes
    adc_lanes: int = 512
    optical_pass_s: float = 1.0e-9
    mac_energy_j: float = 1.0e-17  # sub-fJ optical MAC (their claim)
    interface_latency_s: float = 0.0  # per-invocation host<->engine handshake
    device_sync_s: float = 0.0        # per-device sync epsilon (sharded mode)

    def macs_per_pass(self) -> int:
        return self.rows * self.cols

    def step_cost(self, n_in: int, n_out: int, host_s: float = 0.0) -> StepCost:
        dac_s = self.dac.time_for(n_in, self.dac_lanes)
        adc_s = self.adc.time_for(n_out, self.adc_lanes)
        return StepCost(dac_s=dac_s, adc_s=adc_s,
                        interface_s=self.interface_latency_s,
                        analog_s=self.optical_pass_s, host_s=host_s)

    def _group_sides(self, n_in: int, n_out: int | None, *, batch: int,
                     pipeline_depth: int, n_devices: int,
                     tile_k: int | None, mem_budget,
                     resident_frames: int, weight_samples: int,
                     resident_weights: int,
                     delta_fractions: tuple = (),
                     ) -> tuple[float, float, float, float, float, float,
                                int]:
        """Unoverlapped totals of one invocation in the shared side layout
        ``(dac_s, adc_s, intf_in, intf_out, analog_s, serial_s, stages)``.
        The MVM handshake has no known write/read split, so it rides the
        serial slot (with the sync barriers) and the in/out interface
        slots stay zero.  ``delta_fractions`` scale the written frames'
        DAC term exactly as on the 4f family (resident → delta → full
        frame order per tile; the handshake stays whole)."""
        if n_out is None:
            n_out = n_in
        if batch < 1:
            raise ValueError("batch must be >= 1")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        if resident_frames < 0 or weight_samples < 0 or resident_weights < 0:
            raise ValueError("residency counts must be >= 0")
        deltas = tuple(float(f) for f in delta_fractions)
        for f in deltas:
            if not 0.0 < f <= 1.0:
                raise ValueError("delta fractions must be in (0, 1]")
        if len(deltas) + min(int(resident_frames), batch) > batch:
            raise ValueError(
                "resident_frames + len(delta_fractions) exceeds batch")
        if tile_k is None and mem_budget is not None:
            tile_k = mem_budget.tile_for_group(
                n_in, n_out, batch, pipeline_depth=pipeline_depth)
        if tile_k is not None and tile_k < 1:
            raise ValueError("tile_k must be >= 1")
        sizes = tile_sizes(batch, batch if tile_k is None else tile_k)
        dac_s = adc_s = analog_s = intf_s = 0.0
        stages = 0
        remaining = min(int(resident_frames), batch)
        di = 0
        for b in sizes:
            eff = min(n_devices, b)
            pb = math.ceil(b / eff)
            res_b = min(remaining, b)
            remaining -= res_b
            wb = pb - min(math.ceil(res_b / eff), pb)
            written = b - res_b
            take = min(len(deltas) - di, written)
            if wb:
                d = self.dac.time_for(wb * n_in, self.dac_lanes)
                if take > 0 and written:
                    tile_deltas = deltas[di:di + take]
                    di += take
                    d *= (math.fsum(tile_deltas) + (written - take)) / written
                dac_s += d
            adc_s += self.adc.time_for(pb * n_out, self.adc_lanes)
            analog_s += pb * self.optical_pass_s
            intf_s += self.interface_latency_s
            stages += pb
            if n_devices > 1:
                intf_s += eff * self.device_sync_s
        w_extra = max(0, int(weight_samples) - int(resident_weights))
        if w_extra:
            dac_s += self.dac.time_for(w_extra, self.dac_lanes)
        # overlappable stages only: a serial engine composes as one stage
        # (same rule as the 4f family — keeps degenerate one-engine
        # composition exactly equal to the pipeline_depth price)
        if pipeline_depth < 2:
            stages = 1
        return dac_s, adc_s, 0.0, 0.0, analog_s, intf_s, stages

    def _compose_engines(self, engines, *, host_s: float = 0.0,
                         hold_s: float = 0.0) -> StepCost:
        """Price concurrent per-engine pipeline windows — see
        :meth:`OpticalFourierAcceleratorSpec._compose_engines`; the
        composition discipline (:func:`_compose_sides`) is shared."""
        if not engines:
            raise ValueError("engines must name at least one engine")
        sides: dict = {}
        for name, e in engines.items():
            if isinstance(e, StepCost):
                sides[name] = (e.dac_s, e.adc_s, 0.0, 0.0, e.analog_s,
                               e.interface_s, 1)
                continue
            kw = dict(e)
            sides[name] = self._group_sides(
                kw.pop("n_in"), kw.pop("n_out", None),
                batch=kw.pop("batch", 1),
                pipeline_depth=kw.pop("pipeline_depth", 1),
                n_devices=kw.pop("n_devices", 1),
                tile_k=kw.pop("tile_k", None),
                mem_budget=kw.pop("mem_budget", None),
                resident_frames=kw.pop("resident_frames", 0),
                weight_samples=kw.pop("weight_samples", 0),
                resident_weights=kw.pop("resident_weights", 0),
                delta_fractions=kw.pop("delta_fractions", ()))
            if kw:
                raise ValueError(f"unknown engine kwargs for {name!r}: "
                                 f"{sorted(kw)}")
        return _compose_sides(sides, host_s=host_s, hold_s=hold_s)

    def batched_step_cost(self, n_in: int, n_out: int | None = None, *,
                          batch: int = 1, host_s: float = 0.0,
                          pipeline_depth: int = 1,
                          n_devices: int = 1,
                          hold_s: float = 0.0,
                          tile_k: int | None = None,
                          mem_budget=None,
                          resident_frames: int = 0,
                          weight_samples: int = 0,
                          resident_weights: int = 0,
                          delta_fractions: tuple = (),
                          engines=None) -> StepCost:
        """One invocation streaming ``batch`` same-shape activation sets.

        ``hold_s`` charges continuous-batching queueing delay to the
        invocation wall, exactly as on the 4f family.

        ``pipeline_depth >= 2`` models double-buffered streaming: the DAC
        loads activation set b+1 while set b is in the optical core / ADC,
        so each steady-state stage costs ``max(dac, adc + pass)`` instead
        of their sum.  The hidden (faster) side is charged only its exposed
        1/stages prologue share — see
        :meth:`OpticalFourierAcceleratorSpec.batched_step_cost`.

        ``n_devices >= 2`` prices sharded execution across replicated MVM
        engines: max-over-devices (each device streams its
        ``ceil(batch / n_devices)`` share through its own converters) plus
        one ``device_sync_s`` per participating device (at most ``batch``
        of them can take a shard).

        ``tile_k`` / ``mem_budget`` price memory-budgeted tiled dispatch,
        exactly as on the 4f family: the batch streams as ``ceil(batch /
        tile_k)`` sub-invocations, each paying its own handshake
        (``interface_latency_s``) and — under sharding — its own per-device
        sync, with consecutive tiles overlapped two-deep when
        ``pipeline_depth >= 2``.  ``mem_budget`` duck-types
        ``tile_for_group(n_in, n_out, k, pipeline_depth=...)``
        (``repro_torch.runtime.tiling.MemoryBudget``) — the executor's exact
        resolution, divisor refinement included.

        ``resident_frames`` prices operand residency exactly as on the 4f
        family: that many activation sets are already loaded on the device,
        so they pay no input DAC conversion, while the read side (ADC,
        optical pass) still prices the full batch.  ``weight_samples`` /
        ``resident_weights`` charge the write of a *non-resident* weight
        panel through the DAC once per invocation (``matmul_cost`` prices
        weights as held in the optical domain — residency is the mechanism
        that keeps that assumption honest).  Defaults of 0 reproduce the
        historical price bit for bit.

        ``delta_fractions`` prices delta-encoded staging exactly as on the
        4f family: per-written-frame write scales in (0, 1] applied to the
        input DAC term (the handshake and read side stay whole), with
        ``resident_frames + len(delta_fractions) <= batch`` enforced and
        hit ≤ delta ≤ full-write pricing guaranteed by construction.

        ``engines`` switches to the cross-engine composition mode, exactly
        as on the 4f family.
        """
        if engines is not None:
            return self._compose_engines(engines, host_s=host_s,
                                         hold_s=hold_s)
        dac_s, adc_s, _i1, _i2, analog_s, intf_s, stages = (
            self._group_sides(n_in, n_out, batch=batch,
                              pipeline_depth=pipeline_depth,
                              n_devices=n_devices, tile_k=tile_k,
                              mem_budget=mem_budget,
                              resident_frames=resident_frames,
                              weight_samples=weight_samples,
                              resident_weights=resident_weights,
                              delta_fractions=delta_fractions))
        if pipeline_depth >= 2 and stages > 1:
            hidden = 1.0 / stages
            if dac_s <= adc_s + analog_s:
                dac_s *= hidden
            else:
                adc_s *= hidden
                analog_s *= hidden
        return StepCost(dac_s=dac_s, adc_s=adc_s, interface_s=intf_s,
                        analog_s=analog_s, host_s=host_s, hold_s=hold_s)

    def matmul_cost(self, m: int, k: int, n: int, *,
                    weight_write: bool = False) -> StepCost:
        """Cost of an (m,k) @ (k,n) matmul tiled onto the optical core.

        The (k,n) operand is treated as weights (pre-loaded); the (m,k)
        activations stream through the converters.  Tiling: ceil(k/rows) *
        ceil(n/cols) passes per activation row-block.

        ``weight_write=True`` additionally charges loading the (k,n)
        weight panel through the DAC — the price of a residency *miss*.
        The default (False) is the historical weight-stationary assumption:
        the panel is already resident, loading amortized away.  The
        runtime's residency cache is what makes the default honest — it
        charges the write on the first sighting of a panel and skips it on
        hits, instead of assuming every panel was always resident.
        """
        row_tiles = math.ceil(k / self.rows)
        col_tiles = math.ceil(n / self.cols)
        passes = m * row_tiles * col_tiles
        n_in = m * k * col_tiles          # activations re-enter per col tile
        n_out = m * n * row_tiles         # partials exit per row tile
        dac_s = self.dac.time_for(n_in, self.dac_lanes)
        if weight_write:
            dac_s += self.dac.time_for(k * n, self.dac_lanes)
        adc_s = self.adc.time_for(n_out, self.adc_lanes)
        return StepCost(dac_s=dac_s, adc_s=adc_s, interface_s=0.0,
                        analog_s=passes * self.optical_pass_s)


# --- Named instances ---------------------------------------------------------

# Calibrated to the paper's Fig. 8 measurement: a 1024x768 Fourier transform
# takes 5.209 s end to end on the prototype, 99.599 % of it data movement,
# vs 0.219 s for the software FFT on the same Raspberry Pi 4.  The prototype
# drives the SLM and reads the camera over 60 Hz-display-class USB/DSI links.
PROTOTYPE_4F = OpticalFourierAcceleratorSpec(
    name="prototype-4f",
    slm_pixels=(1024, 768),
    dac_lanes=1,
    adc_lanes=1,
    slm_interface_hz=300_164.0,    # 2.620 s to program 786,432 pixels
    camera_interface_hz=306_256.0, # 2.568 s to read them back
    slm_settle_s=10.0e-3,
    exposure_s=11.0e-3,
    path_length_m=0.5,
)

# The paper's "ideal" accelerator for the Amdahl study: FFT/conv cost == 0.
IDEAL_4F = OpticalFourierAcceleratorSpec(
    name="ideal-4f",
    slm_pixels=(4096, 4096),
    dac_lanes=10**9,
    adc_lanes=10**9,
    slm_interface_hz=math.inf,
    camera_interface_hz=math.inf,
    slm_settle_s=0.0,
    exposure_s=0.0,
    path_length_m=0.0,
)

# Anderson et al. optical transformer MVM engine, evaluated at honest
# (on-frontier) converter costs — the paper's §2 critique target.
ANDERSON_MVM = OpticalMVMAcceleratorSpec(name="anderson-mvm")
