"""Drive the PyTorch/CUDA port on one CUDA card and check it end to end.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version on the card, and drives the port's
two paths, each with every kernel's launch count set to 0 just before it
and read just after:

* the offload path: 16 frames of 512x512 through ``OffloadExecutor`` +
  ``PlanRouter`` on the ``optical-sim`` backend (spec ``BATCHED_4F``), then
  the 3-layer 512x512 conv stack;
* the serving path: stablelm-1.6b at full width and depth (random weights
  from a seed) serving 8 requests through ``ServingEngine`` with 4 slots,
  every prefill's attention through the flash-attention kernel's
  tensor-core route (``wgmma`` + TMA), with an
  ``OffloadScheduler`` on the engine's aux hook carrying 512x512 ``fft``
  frames through the DFT kernels;
* the training path: stablelm-1.6b at full width and depth taking 5 AdamW
  steps (1 warm-up, 4 timed) through ``launch.train.train_loop`` on a
  ``MarkovTask`` of 4 x 1024 tokens, every block rematerialized, every
  attention through the flash-attention kernel's tensor-core forward and
  its ``mma.sync`` backward;
* the converter boundary's entry point ``ops.converter_boundary`` on a
  2048x2048 float32 SLM frame and a 4096x2048 bfloat16 activation, with
  and without noise: one launch of its resident route a call, that route
  and the streamed one bit-equal to the plain version;
* the sharded runtime: the offload path's 16 frames through
  ``OffloadExecutor(n_devices=4, default_backend="sharded")``, bit-equal
  to the unsharded flush with every DFT launch on the tensor-core route;
  a frame-sharded conv of one 2560x2048 frame (larger than the SLM); a
  seeded chaos run (``register_chaos("sharded", rate=0.3, seed=0)``)
  under a ``ManualClock`` in which every frame retires; and a traced
  sharded flush written with ``write_trace`` and reconciled.  With one
  card the four logical devices run in turn on it; with four or more,
  each shard goes to a card of its own;
* the paper's case study: the 27 benchmarks of Table 1 through
  ``casestudy.amdahl_suite.run_suite`` on the card, every bracketed call
  on the card with the reference's call and sample counts, each
  benchmark's first bracketed output held to the CPU's on the same
  inputs; Table 1 beside the paper's, Fig. 8's software FFT, and
  ``flops_by_category`` of an LM loss on the card (its attention through
  kernel 6) against the same count on ``meta``; the planner table's rows
  for every ported architecture (dense, recurrent and MoE), priced at the
  H100's bf16 peak.  It launches no hand-written kernel, and checks that;
* the runtime bench at the reference's sizes and both examples' mains;
* dense serving at full width: qwen2.5-32b at its full width and depth
  (64 layers, 65.5 GB of bf16 weights) and nemotron-4-340b at its full
  width with its depth cut to 4 of 96 layers (46.5 GB; all 96 would be
  682 GB), each serving the serving path's 8 requests with aux fft
  frames, every prefill's attention on kernel 6's tensor-core route (D
  128 with GQA 5, D 192 with GQA 12), tokens against an offline greedy
  loop; kernel 6 at each model's prefill shape against its plain
  version, forward and backward, and at D 256;
* the recurrent families: recurrentgemma-9b at its published width and
  depth (38 layers, 20.8 GB of bf16 weights) serving 8 prompts of
  512-4096 tokens (four past its 2048 window) with max_len 4608, every
  prefill's local attention on kernel 6's tensor-core route at D 256,
  tokens against an offline greedy loop, and kernel 6 at (16 / 1, 4096,
  256) window 2048 beside SDPA with the same band mask; xlstm-125m at
  full width and depth taking 20 AdamW steps of 8 x 128 tokens through
  ``examples/train_lm.py``'s twin, its loss falling, and 2 steps under
  each remat switch equal to "full"; one Adafactor step and one int8
  error-feedback round at a qwen2.5-32b layer's shapes, card against
  CPU; kernel 6 past D 256 (257, 320, 512) forward and backward against
  its plain version;
* MoE serving at full width: qwen2-moe-a2.7b at its published width and
  depth (24 layers, 60 routed experts top-4 and 4 shared, 28.6 GB of
  bf16 weights) and deepseek-v3-671b at its full width with its depth
  cut to 5 of 61 layers (its 3 dense layers and 2 MoE ones of 256
  experts top-8, MLA; 53.3 GB), one at a time, each serving the serving
  path's 8 requests with aux fft frames, every prefill's attention on
  kernel 6's tensor-core route (D 128; MLA at D 192 with V padded from
  128), tokens against an offline greedy loop, the share of routed slots
  each prefill drops for capacity; kernel 6 at each model's prefill
  shape against its plain version, forward and backward, and V narrower
  than q and k in f32 and bf16;
* the encoder-decoder and vision families at full width and depth:
  seamless-m4t-large-v2 (24 encoder + 24 decoder layers, 8.16 GB of
  float32 weights) and llava-next-34b (60 layers, 68.9 GB of bf16), one
  after the other, each answering 4 requests in one batch through
  ``LM.prefill`` / ``LM.decode_step`` (seamless: 1024 encoder frames and
  a 128-token prompt each; llava: 576 patches and 512 tokens each), 32
  greedy tokens a request, every request's tokens against the request
  alone on 4 identical lanes and prefilled at 1 lane (seamless's at
  float32 activations); kernel 6 on the tensor-core route for the
  non-causal encoder, the decoder's self-attention, cross-attention at
  Lq 128 and, every decode step, at Lq 1 against the 1024 frames, and
  llava's GQA 7 at D 128; one seamless ``LM.loss`` + backward at 2 x 512
  tokens and 1024 frames with every gradient finite; kernel 6 at every
  shape each run launched it (the run's launches counted per shape)
  against its plain version, SDPA and its bound, the backward too;
* the mesh: stablelm-1.6b at full width and depth taking one AdamW step
  of phase 6's Markov batch (4 x 1024 tokens) on a (1, 1) ``(data,
  model)`` CUDA mesh over a one-rank NCCL process group, its params,
  AdamW state and batch DTensors laid out by ``param_pspecs``,
  ``opt_pspecs`` and ``batch_pspecs``; the loss against the same step
  unmeshed on the same params and batch (within the reference test's
  5e-2), the placements kept, kernel 6 launched 48 times forward and 24
  backward a step on the tensor-core route, on the local shards, and held
  to its plain version at that shape; the step's wall and peak memory
  beside the unmeshed step's; and the dry run
  (``python -m repro_torch.launch.dryrun``) of stablelm-1.6b ``train_4k``
  on both production meshes, qwen2-moe-a2.7b ``decode_32k``, and
  qwen2.5-32b's and llava-next-34b's ``train_4k`` (padded heads) on
  16x16, in a subprocess: each record's global counts, every configured
  microbatch counted, its partitioned pass on meta DTensors (FLOPs,
  bytes and collective bytes a device, a Shard-to-Shard redistribute as
  the all-to-all the card sends) and its roofline row at the H100's
  constants, one cross-entropy chunk's collectives beside their shape
  arithmetic, and the padded cells' x split;
* the mesh's serving and the roofline against the card: qwen2-moe-a2.7b
  at full width and depth, a prefill of 1024 tokens and 16 greedy decode
  steps unmeshed and on the (1, 1) mesh with params, tokens and cache
  DTensors, logits, cache and tokens equal (within 1e-6), kernel 6 24
  times on the tensor-core route through the DTensor path, both runs'
  walls; and two one-card roofline rows, phase 6's training step and
  phase 5's decode step counted on ``meta`` here, beside their measured
  walls and device busy times, no wall below its bound;
* training the MoE, MLA and hybrid families at their published widths:
  qwen2-moe-a2.7b on 4 of 24 layers (4 x 1024 tokens), deepseek-v3-671b's
  3 dense MLA layers (2 x 1024) and recurrentgemma-9b on 5 of 38 layers
  (2 x 4096, so that its 2048 window masks), each taking 6 donated AdamW
  steps of the train CLI's ``MarkovTask``: losses finite and falling,
  every gradient leaf finite, kernel 6's forward and backward only on
  the tensor-core route at the model's one shape, and a repeated
  ``loss_and_grads`` + AdamW step bit-equal in loss, gradients and
  parameters (the MoE layer's gathers have a fixed-order backward); each
  step's wall, tokens/s, model FLOP/s and peak memory, one profiled step
  by kernel kind, and kernel 6's backward at each shape beside its plain
  version, SDPA and its bound.

It times each kernel beside its plain version, a library call and its
bound, and prints as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check raises, so the exit code is non-zero and no result line
is printed.  Without a CUDA card it exits with code 2.

It imports ``torch``, numpy and ``repro_torch`` only.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
FRAMES = 16          # one flush group: 16 frames tiled onto the 2048^2 SLM
SIDE = 512           # frame side, as examples/optical_offload.py runs it
TIMED_RUNS = 21      # CUDA-event samples per timing (median reported)

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores,
# TF32 and bf16 on the tensor cores, and HBM3 bandwidth.  The DFT kernels
# take fp32 operands: their FMA route runs at the fp32 rate, their
# tensor-core route three TF32 products for each fp32 one (3xTF32).  The
# attention kernel's operands on the serving path are bf16.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

# the serving path: stablelm-1.6b at full width, 4 cache slots
ARCH = "stablelm-1.6b"
SLOTS = 4
MAX_LEN = 2048
MAX_NEW = 16
PROMPT_LENS = (200, 517, 1000, 333, 129, 777, 1023, 450)  # none divides by 64
OFFLINE_RIDS = (1, 6)    # one request of each admission round
AUX_FRAMES = 4           # 512x512 fft frames on the engine's aux hook
ATTN_TIMED_LENS = (512, 1024)

# the training path: stablelm-1.6b at full width, 4 x 1024 tokens a step
TRAIN_BATCH = 4
TRAIN_SEQ = 1024
TRAIN_STEPS = 5          # 1 warm-up step + 4 timed
TRAIN_CKPT = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"

# the mesh: one step on a (1, 1) (data, model) mesh, and the dry run's
# cell of the same model
MESH_SHAPE = (1, 1)
# on one card the meshed step does the unmeshed step's work in the same
# order: its loss, gradient norm and update agree to this (relative for
# the last two)
MESH_TOL = 1e-6
DRYRUN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dryrun"
DRYRUN_TIMEOUT_S = 300
# the dry run's cells: (arch, shape, meshes), the training cell of the
# mesh's model on both production meshes, the MoE decode cell on 16x16,
# and the two training cells whose query heads ``model`` (16) does not
# divide, which run on padded head splits
DRYRUN_CELLS = (("stablelm-1.6b", "train_4k", "both"),
                ("qwen2-moe-a2.7b", "decode_32k", "single"),
                ("qwen2.5-32b", "train_4k", "single"),
                ("llava-next-34b", "train_4k", "single"))
# the padded cell's x split (a device's FLOPs over the global FLOPs over
# its devices) without kernel 6's charged work stays in the band of the
# production cells whose heads ``model`` divides (their dry-run records:
# 1.00-1.30)
X_SPLIT_BAND = (1.0, 1.30)

# the sharded runtime: 4 logical devices; one conv frame larger than
# BATCHED_4F's 2048^2 aperture; chaos flushes until every injected kind
# has shown up (at most CHAOS_FLUSHES)
SHARDS = 4
FRAME_SHARDED = (2560, 2048)
CHAOS_FLUSHES = 12
TRACE_DIR = Path(__file__).resolve().parent / "build"

# the converter boundary: one BATCHED_4F SLM frame (2048^2, float32) and
# stablelm-1.6b's activation at the training batch (4 x 1024 tokens x 2048)
BOUNDARY_CASES = [((2048, 2048), torch.float32), ((4096, 2048),
                                                  torch.bfloat16)]
BOUNDARY_NOISE_STD = 0.02

# the paper's case study: one run of each of the 27 benchmarks brackets
# these calls, samples in and samples out by category (the reference's
# suite, benchmarks/amdahl_suite.py, gives the same: the CPU test
# tests/test_torch_casestudy.py holds both to this table).  The card's
# first bracketed output of each benchmark is held to the CPU's on the
# same inputs within the CPU test's replay bound.
CASESTUDY_COUNTS = {
    "convolution": {"conv": (4, 80_000, 158_404)},
    "fourier_transform": {"fft": (1, 2_250_000, 2_250_000)},
    "wiener_filter": {"conv": (2, 1_280_050, 1_280_000)},
    "airy_beam": {"fft": (6, 1_572_864, 1_572_864)},
    "youngs_experiment": {"fft": (1, 262_144, 262_144)},
    "poisson_to_bessel": {"fft": (4, 1_048_576, 1_048_576)},
    "bessel_annular_slit": {"fft": (3, 786_432, 786_432)},
    "bessel_axicon": {"fft": (3, 786_432, 786_432)},
    "multi_holes_slits": {"fft": (1, 262_144, 262_144)},
    "circular_aperture": {"fft": (1, 262_144, 262_144)},
    "shack_hartmann": {"fft": (1, 262_144, 262_144)},
    "spot_of_poisson": {"fft": (1, 262_144, 262_144)},
    "fresnel_zone_plate": {"fft": (1, 262_144, 262_144)},
    "unstable_resonator": {"fft": (16, 1_048_576, 1_048_576)},
    "doughnut_collinear": {"fft": (2, 524_288, 524_288)},
    "michelson": {"fft": (1, 262_144, 262_144)},
    "phase_recovery": {"fft": (30, 1_966_080, 1_966_080)},
    "spiral_phase_plate": {"fft": (1, 262_144, 262_144)},
    "hermite_to_laguerre": {"fft": (2, 131_072, 131_072)},
    "doughnut_tilted": {"fft": (1, 262_144, 262_144)},
    "double_slit_prysm": {"fft": (1, 147_456, 147_456)},
    "first_diffraction_model": {"fft": (2, 294_912, 294_912)},
    "image_simulation": {"fft": (1, 147_456, 147_456),
                         "conv": (1, 294_912, 147_456)},
    "cnn_inference": {"conv": (2, 472_752, 1_572_864)},
    "cnn_training": {"conv": (4, 945_504, 3_145_728)},
    "audio_resampling": {"conv": (1, 192_000, 64_000)},
    "wav2vec2_inference": {"conv": (4, 782_016, 767_744)},
}
CASESTUDY_REL = 1e-4     # |card - cpu| <= 1e-4 * max|cpu|
PAPER_MEDIAN, PAPER_MEAN = 1.94, 9.39

SOURCE = "src/repro_torch/csrc/optical_dft.cu"
ATTN_SOURCE = "src/repro_torch/csrc/local_attention.cu"
ADC_SOURCE = "src/repro_torch/csrc/adc_dac.cu"
REPLACES = {
    "dft_stage1_batched": "src/repro/kernels/optical_dft.py:176",
    "dft_stage2_batched": "src/repro/kernels/optical_dft.py:305",
    "local_flash_attention": "src/repro/kernels/local_attention.py:106",
    # the reference differentiates its chunked jnp attention instead
    "local_flash_attention_backward":
        "src/repro/kernels/local_attention.py:106",
    "converter_boundary": "src/repro/kernels/adc_dac.py:62",
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


TC_KERNELS = ("attention_tc_kernel", "attention_bwd_kv_tc_kernel",
              "attention_bwd_q_tc_kernel")
TC_HEAD_DIMS = (64, 128, 192, 256)
# kernel 6's FMA kernels (each at 3 dtypes and 7 head-dim buckets, and
# the wide kernels past 256)
FMA_KERNELS = ("attention_kernel", "attention_bwd_kv_kernel",
               "attention_bwd_q_kernel")
# kernel 6's kernels as the profiler names them, both routes
KERNEL6_NAMES = TC_KERNELS + ("attention_kernel<", "attention_bwd_kv_kernel<",
                              "attention_bwd_q_kernel<", "delta_kernel<")
# the DFT kernels' tensor-core route
DFT_TC_KERNELS = ("stage1_tc_kernel", "stage2_tc_kernel")
# kernel 5's kernels: the resident route's, then the streamed route's two
BOUNDARY_KERNELS = ("boundary_resident_kernel", "boundary_max_kernel",
                    "boundary_stream_kernel")


def is_kernel6(name: str) -> bool:
    return any(k in name for k in KERNEL6_NAMES)


def ptxas_report(log: str, kernels: tuple[str, ...]) -> list[dict]:
    """Registers and spill bytes of the named kernels (each template
    instance, with its head dim ``d`` where it has one), from the
    compiler's ``-Xptxas -v`` report of their library."""
    rows, entry = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            entry = next(({"kernel": k, "entry": name,
                           "d": (int(name.split(k + "ILi")[1].split("E")[0])
                                 if k + "ILi" in name else None)}
                          for k in kernels if k in name), None)
        elif entry is not None and "spill stores" in line:
            words = line.replace(",", "").split()
            entry["spill_bytes"] = (int(words[words.index("spill") - 2]) +
                                    int(words[-4]))
        elif entry is not None and "Used" in line and "registers" in line:
            words = line.replace(",", "").split()
            entry["registers"] = int(words[words.index("registers") - 1])
            rows.append(entry)
            entry = None
    return rows


def rng_frames(rng: np.random.Generator, shape, dev) -> torch.Tensor:
    return torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev)


def max_violation(got: torch.Tensor, want: torch.Tensor, rtol: float,
                  atol: float) -> float:
    """max(|got - want| - (atol + rtol |want|)); <= 0 means within bounds."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def median_ms(fn, runs: int = TIMED_RUNS, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_profile(fn, calls: int = 20, flush=None
                   ) -> tuple[float | None, dict, dict]:
    """Device time per call of ``fn`` under torch.profiler over ``calls``
    calls: the total, the same per kernel name, and the CUDA launch API
    calls per call by name (``cudaLaunchKernel``,
    ``cudaLaunchCooperativeKernel``, ...).  A kernel's time per call is its
    mean per launch times its launches per call: late in a long process
    the tracer can miss a launch now and then, or a whole window, which is
    then run again (the API calls are counted on the host).  With
    ``flush``, each call follows one ``flush()``, whose kernels are left
    out.  (None, {}, {}) when the profiler reports no device time."""
    from torch.profiler import ProfilerActivity, profile

    def window(work, n):
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    work()
                torch.cuda.synchronize()
            evs = prof.key_averages()
            kernels = [e for e in evs if e.count and e.device_type ==
                       torch.autograd.DeviceType.CUDA]
            if kernels:
                return evs, kernels
        return evs, []

    skip = set()
    if flush is not None:
        skip = {e.key for e in window(flush, 4)[1]}
        if not skip:
            return None, {}, {}

    def work():
        if flush is not None:
            flush()
        fn()
    for _ in range(3):
        work()
    torch.cuda.synchronize()
    evs, kernels = window(work, calls)
    by_name = {e.key: e.self_device_time_total / 1e3 / e.count
               * max(1, round(e.count / calls)) for e in kernels
               if e.key not in skip}
    api = {e.key: e.count / calls for e in evs
           if e.key.startswith(("cudaLaunch", "cuLaunch"))}
    total = sum(by_name.values())
    return (total if total else None), by_name, api


def _sleep_cycles_per_ms() -> float:
    """The rate of ``torch.cuda._sleep``'s spin, in cycles per ms."""
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(1000)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 1e7 / a.elapsed_time(b)


def held_ms(fn, calls: int = 20, flush=None) -> float:
    """Device time per call of ``fn`` from CUDA events.  The card is held
    busy (``torch.cuda._sleep``) for twice the time the host takes to
    queue the work, so the host's launch path never shows in an interval.
    Without ``flush``, one interval over ``calls`` calls back to back;
    with it, one interval per call after its ``flush()`` (the median)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        if flush is not None:
            flush()
        fn()
    torch.cuda.synchronize()
    hold_ms = 2e3 * (time.perf_counter() - t0) + 1.0
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(1 if flush is None else calls)]
    torch.cuda._sleep(int(hold_ms * _sleep_cycles_per_ms()))
    if flush is None:
        pairs[0][0].record()
        for _ in range(calls):
            fn()
        pairs[0][1].record()
    else:
        for a, b in pairs:
            flush()
            a.record()
            fn()
            b.record()
    torch.cuda.synchronize()
    if flush is None:
        return pairs[0][0].elapsed_time(pairs[0][1]) / calls
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_ms(fn, calls: int = 20) -> tuple[float | None, dict]:
    """Device time per call of ``fn`` (``device_profile``'s first two
    results), for work so short that the host's launches, not the card,
    set the event-timed wall."""
    total, by_name, _ = device_profile(fn, calls)
    return total, by_name


def sdpa_backend(fn) -> tuple[str, list[str]]:
    """Which ``scaled_dot_product_attention`` backend a call of ``fn``
    ran, from the kernel names the profiler saw (cudnn's fused kernels
    carry "flash" in their names too, so it is looked for first): cudnn,
    flash, efficient (the CUTLASS memory-efficient kernel) or math (plain
    GEMMs and a softmax); and the names themselves."""
    _, by_name = device_ms(fn, calls=5)
    names = " ".join(by_name).lower()
    for key, name in (("cudnn", "cudnn"), ("flash", "flash"),
                      ("fmha", "efficient"), ("efficient", "efficient")):
        if key in names:
            return name, sorted(by_name)
    return ("math" if names else "not seen"), sorted(by_name)


# --- phase 2: kernels against their plain versions ---------------------------


def stage_inputs(od, rng, batch, m, k, n, dev):
    """W (m, k) from the unitary factors of size k (rows repeated when
    m > k), A (batch, k, n) uniform in [0, 1)."""
    wr, wi = od.dft_matrix_factors(k, device=dev)
    reps = -(-m // k)
    wr, wi = wr.repeat(reps, 1)[:m].contiguous(), \
        wi.repeat(reps, 1)[:m].contiguous()
    return wr, wi, rng_frames(rng, (batch, k, n), dev)


def check_stage1(od, rng, shape, dev, dac_bits=8, a=None):
    batch, m, k, n = shape
    wr, wi, a0 = stage_inputs(od, rng, batch, m, k, n, dev)
    a = a0 if a is None else a
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=dac_bits)
    pr, pi = od.dft_stage1_batched_plain(wr, wi, a, dac_bits=dac_bits)
    torch.cuda.synchronize()
    v = max(max_violation(tr, pr, 1e-4, 1e-5),
            max_violation(ti, pi, 1e-4, 1e-5))
    err = max(float((tr - pr).abs().max()), float((ti - pi).abs().max()))
    check(v <= 0.0, f"stage 1 {shape} dac_bits={dac_bits}: "
          f"max |err| {err:.3e} outside rtol 1e-4 / atol 1e-5")
    return err


def check_stage2(od, rng, shape, dev):
    batch, m, k, n = shape
    wr, wi = od.dft_matrix_factors(k, device=dev)
    reps = -(-n // k)
    wr, wi = wr.repeat(reps, 1)[:n].contiguous(), \
        wi.repeat(reps, 1)[:n].contiguous()
    tr = rng_frames(rng, (batch, m, k), dev)
    ti = rng_frames(rng, (batch, m, k), dev)
    got = od.dft_stage2_batched(tr, ti, wr, wi)
    want = od.dft_stage2_batched_plain(tr, ti, wr, wi)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    check(max_violation(got, want, 1e-4, 1e-4 * float(want.max())) <= 0.0,
          f"stage 2 {shape}: max |err| {err:.3e} outside rtol 1e-4 / "
          "atol 1e-4*max")
    return err


def check_pipeline(od, rng, shape, dev, dac_bits):
    """Both kernels against the fft2 oracle, frame by frame."""
    a = rng_frames(rng, shape, dev)
    got = od.optical_dft2_intensity_batched(a, dac_bits=dac_bits)
    q = a
    if dac_bits:
        levels = (1 << dac_bits) - 1
        q = torch.round(torch.clamp(a, 0.0, 1.0) * levels) / levels
    want = torch.fft.fft2(q.to(torch.complex64), norm="ortho").abs() ** 2
    torch.cuda.synchronize()
    for i in range(shape[0]):
        check(max_violation(got[i], want[i], 2e-4,
                            2e-4 * float(want[i].max())) <= 0.0,
              f"pipeline {shape} dac_bits={dac_bits} frame {i} outside "
              "rtol 2e-4 / atol 2e-4*max of fft2")


def check_bit_equal(od, rng, dev) -> None:
    """Frame i of a (16, 512, 512, 512) call of each stage is bit-equal to
    the single-frame call, and the batched call to its repeat."""
    wr, wi = od.dft_matrix_factors(SIDE, device=dev)
    a = rng_frames(rng, (FRAMES, SIDE, SIDE), dev)
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=8)
    out = od.dft_stage2_batched(tr, ti, wr, wi)
    for i in range(FRAMES):
        tr1, ti1 = od.dft_stage1(wr, wi, a[i], dac_bits=8)
        check(torch.equal(tr1, tr[i]) and torch.equal(ti1, ti[i]),
              f"stage 1: frame {i} alone differs from the batch of 16")
        check(torch.equal(od.dft_stage2(tr[i], ti[i], wr, wi), out[i]),
              f"stage 2: frame {i} alone differs from the batch of 16")
    tr2, ti2 = od.dft_stage1_batched(wr, wi, a, dac_bits=8)
    check(torch.equal(tr2, tr) and torch.equal(ti2, ti)
          and torch.equal(od.dft_stage2_batched(tr, ti, wr, wi), out),
          "a repeat of the batch of 16 differs")


def phase_kernels(od, dev, tile_k: int) -> dict[str, float]:
    rng = np.random.default_rng(SEED)
    main = (FRAMES, SIDE, SIDE, SIDE)
    # every shape but the last takes the tensor-core route; the last (n
    # not a multiple of 4) the FMA route
    shapes = [main, (tile_k, SIDE, SIDE, SIDE), (1, SIDE, SIDE, SIDE),
              (5, 64, 64, 64), (1, 8, 256, 128), (3, 128, 128, 256),
              (2, 100, 96, 130)]
    err = {"dft_stage1_batched": 0.0, "dft_stage2_batched": 0.0}
    od.reset_launches()
    for shape in shapes:
        e1 = check_stage1(od, rng, shape, dev)
        e2 = check_stage2(od, rng, shape, dev)
        if shape == main:
            err = {"dft_stage1_batched": e1, "dft_stage2_batched": e2}
        print(f"  stage 1/2 {shape}: max |err| {e1:.3e} / {e2:.3e}")
    for fn in (od.dft_stage1_batched, od.dft_stage2_batched):
        check(fn.launches_by_route == {"tensor_core": len(shapes) - 1,
                                       "fma": 1},
              f"{fn.__name__} routes {fn.launches_by_route}")
    for shape in [(FRAMES, SIDE, SIDE), (5, 64, 64), (3, 128, 256),
                  (1, 8, 128)]:
        for bits in (0, 8):
            check_pipeline(od, rng, shape, dev, bits)
    print("  pipeline vs fft2: ok at dac_bits 0 and 8")
    # DAC ties: round half to even, as torch.round does.  0.5 at 8 bits is
    # the tie 127.5; 0.49607843 is the tie 126.5 (even 126, away 127).
    od.reset_launches()
    for value, bits in ((0.5, 8), (0.4960784316062927, 8), (0.5, 1)):
        a = torch.full((1, 64, 64), value, dtype=torch.float32, device=dev)
        check_stage1(od, rng, (1, 64, 64, 64), dev, dac_bits=bits, a=a)
    check(od.dft_stage1_batched.launches_by_route["tensor_core"] == 3,
          "the DAC ties did not run on the tensor-core route")
    print("  DAC ties (0.5 @ 8 b, 126.5/255 @ 8 b, 0.5 @ 1 b): ok, on the "
          "tensor-core route")
    check_bit_equal(od, rng, dev)
    print(f"  ({FRAMES}, {SIDE}, {SIDE}, {SIDE}): each frame bit-equal to its "
          "single-frame call, the batch bit-equal to its repeat")
    return err


# --- phase 3: the main path ---------------------------------------------------

DFT_STAGES = ("dft_stage1_batched", "dft_stage2_batched")


def dft_counts(od) -> tuple[dict, dict]:
    """Each DFT stage's launches and launches by route since the last
    ``od.reset_launches()``."""
    return ({n: getattr(od, n).launches for n in DFT_STAGES},
            {n: dict(getattr(od, n).launches_by_route) for n in DFT_STAGES})



def conv_stack(router, imgs, kernels):
    """The example's 3-layer circular-conv + relu stack."""
    outs = list(imgs)
    for k in kernels:
        handles = [router.submit("conv", x, kernel=k) for x in outs]
        router.executor.flush_async()
        outs = [torch.relu(h.wait().value) for h in handles]
    return outs


def phase_main_path(rt, od, dev) -> dict:
    rng = np.random.default_rng(SEED + 1)
    spec = rt.BATCHED_4F
    ex = rt.OffloadExecutor(spec, max_batch=FRAMES, pipeline_depth=2)
    check(ex.device.type == "cuda", f"executor on {ex.device}")
    router = rt.PlanRouter(ex)
    frames = [rng_frames(rng, (SIDE, SIDE), dev) for _ in range(FRAMES)]
    tile = ex.resolve_tile_k("fft", frames[0], FRAMES)
    ex.warm("fft", frames[0], backend="optical-sim", batch=FRAMES)
    ex.warm("fft", frames[0], backend="host", batch=FRAMES)
    torch.cuda.synchronize()

    od.reset_launches()
    t0 = time.perf_counter()
    handles = [router.submit("fft", x, backend="optical-sim")
               for x in frames]
    ex.flush_async()
    for h in handles:
        h.wait()
    wall_s = time.perf_counter() - t0
    launches, by_route = dft_counts(od)
    print(f"  budget {ex.mem_budget}, tile_k {tile}, launches {launches}, "
          f"by route {by_route}, flush wall {wall_s * 1e3:.3f} ms")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
        check(by_route[name] == {"tensor_core": n, "fma": 0},
              f"{name}: a flush launch left the tensor-core route: "
              f"{by_route[name]}")

    hosts = [ex.submit("fft", x, backend="host") for x in frames]
    ex.flush()
    adc_levels = (1 << spec.adc.bits) - 1
    for i, (h, r) in enumerate(zip(handles, hosts)):
        got, want = h.value, r.value
        check(got.shape == (SIDE, SIDE) and bool(torch.isfinite(got).all()),
              f"frame {i}: shape {tuple(got.shape)} or non-finite values")
        top = float(want.max())
        bound = 2e-4 * top + float(got.max()) / adc_levels
        err = float((got - want).abs().max())
        check(err <= bound, f"frame {i}: |optical - host| {err:.3e} > "
              f"{bound:.3e} (2e-4*max + one 14-bit ADC step)")
        check(h.backend == "optical-sim", f"frame {i} served by {h.backend}")
    checker = rt.FidelityChecker()
    enob = min(spec.dac.effective_bits, spec.adc.effective_bits)
    report = checker.check("fft", "optical-sim", [h.value for h in handles],
                           [r.value for r in hosts], enob=enob)
    print(f"  {report}")
    check(report.ok, "fft fidelity outside the ENOB bound")

    n = SIDE * SIDE
    for h in handles:
        want = spec.batched_step_cost(n, n, batch=h.batch, pipeline_depth=2,
                                      resident_frames=0, delta_fractions=())
        check(h.batch == tile, f"invocation of {h.batch} frames, tile {tile}")
        check(h.cost == want.scaled(1.0 / h.batch),
              "StepCost differs from batched_step_cost at the tile")
    group = spec.batched_step_cost(n, n, batch=FRAMES, pipeline_depth=2,
                                   tile_k=tile)
    print(f"  StepCost per invocation == batched_step_cost(batch={tile}); "
          f"modeled tiled group wall {group.total_s * 1e3:.4f} ms")

    def flush() -> float:
        t0 = time.perf_counter()
        hs = [router.submit("fft", x, backend="optical-sim") for x in frames]
        ex.flush_async()
        for h in hs:
            h.wait()
        return (time.perf_counter() - t0) * 1e3

    walls = [flush() for _ in range(9)]  # repeat flushes, not counted
    profiled = profile_flush(flush)
    ex.close()
    # phase 8 holds the sharded flush to these frames, bit for bit
    return {"_frames": frames, "_values": [h.value for h in handles],
            "_hosts": [r.value for r in hosts],
            "launches": launches, "launches_by_route": by_route,
            "tile_k": tile, "budget_bytes": ex.mem_budget.bytes_limit,
            "budget_source": ex.mem_budget.source,
            "flush_wall_ms": wall_s * 1e3,
            "repeat_flush_wall_ms": walls,
            "repeat_flush_wall_median_ms": statistics.median(walls),
            "profiled_flush": profiled}


KERNEL_CATEGORIES = (("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas",
                               "sm90_", "sm80_")),
                     ("gather/scatter/index", ("gather", "scatter", "index",
                                               "embedding")),
                     ("sort", ("sort", "radix")),
                     ("reduce", ("reduce", "norm", "softmax")),
                     ("copy/cast", ("copy", "cat", "fill")),
                     ("elementwise", ("elementwise", "vectorized")))


def kernel_category(name: str) -> str:
    """A device kernel's kind, read off its name: kernel 6, GEMM,
    gather/scatter/index, sort, reduction, copy or cast, elementwise or
    other."""
    if is_kernel6(name):
        return "kernel6"
    low = name.lower()
    for cat, keys in KERNEL_CATEGORIES:
        if any(k in low for k in keys):
            return cat
    return "other"


def profile_flush(flush, what: str = "flush") -> dict:
    """One run of ``flush`` (which returns its host wall in ms) under
    torch.profiler: device busy time by kernel name against the wall."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = flush()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    k6_ms = sum(e.self_device_time_total for e in device
                if is_kernel6(e.key)) / 1e3
    top = sorted(device, key=lambda e: -e.self_device_time_total)[:8]
    by_category: dict[str, float] = {}
    for e in device:
        cat = kernel_category(e.key)
        by_category[cat] = by_category.get(cat, 0.0) \
            + e.self_device_time_total / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms if wall_ms else None,
           "kernel6_ms": k6_ms, "by_category_ms": by_category,
           "top": [{"name": e.key[:60], "count": e.count,
                    "ms": e.self_device_time_total / 1e3} for e in top]}
    print(f"  profiled {what}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms" + ("" if busy_ms else " (profiler reported no "
                                "device time: not measured)")
          + f", kernel 6 {k6_ms:.3f} ms of it")
    print("    by kind: " + ", ".join(
        f"{cat} {ms:.3f} ms" for cat, ms in sorted(
            by_category.items(), key=lambda kv: -kv[1])))
    for t in out["top"]:
        print(f"    {t['ms']:.4f} ms x{t['count']}  {t['name']}")
    return out


def phase_conv_stack(rt, dev) -> None:
    rng = np.random.default_rng(SEED + 2)
    imgs = [rng_frames(rng, (SIDE, SIDE), dev) for _ in range(8)]
    kernels = []
    for _ in range(3):
        k = np.zeros((SIDE, SIDE), np.float32)
        k[:5, :5] = 0.04 * rng.standard_normal((5, 5)).astype(np.float32)
        k[0, 0] += 0.5
        kernels.append(torch.from_numpy(k).to(dev))
    checker = rt.FidelityChecker()
    with rt.OffloadExecutor(rt.BATCHED_4F, fidelity=checker, max_batch=16,
                            pipeline_depth=2) as ex:
        router = rt.PlanRouter(ex)
        router.routes["conv"] = "optical-sim"
        outs = conv_stack(router, imgs, kernels)
    check(all(o.shape == (SIDE, SIDE) and bool(torch.isfinite(o).all())
              for o in outs), "conv stack output shape / finiteness")
    invocations = ex.telemetry.stats[("conv", "optical-sim")].invocations
    check(len(checker.reports) == invocations >= 3,
          f"{len(checker.reports)} fidelity reports for {invocations} "
          "conv invocations")
    print("  " + checker.summary().replace("\n", "\n  "))
    check(checker.all_ok, "conv stack fidelity outside the ENOB bound")


# --- phase 4: times -------------------------------------------------------------


def entry(od, stage: int, b: int, inputs, outputs, route: int,
          split: int = 1, levels: int = 255):
    """A launcher of a stage's kernel at (b, 512, 512, 512) through its C
    entry point on a given route (0: FMA, 1: tensor cores), split and DAC,
    all of which the wrappers choose themselves: to time the FMA kernel
    beside the tensor-core route on the same inputs, and the tensor-core
    route at other splits."""
    lib = od._lib()
    fn = (lib.optical_dft_stage1_batched if stage == 1
          else lib.optical_dft_stage2_batched)
    lv = (levels,) if stage == 1 else ()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():   # holds the tensors, so that their memory stays theirs
        code = fn(*[x.data_ptr() for x in (*inputs, *outputs)], b, SIDE,
                  SIDE, SIDE, *lv, route, split, stream)
        check(code == 0, f"stage {stage} route {route} launch: error {code}")
    return launch


def stage_work(od, dev, b: int) -> dict:
    """Each DFT stage on (b, 512, 512) inputs: the wrapper (tensor-core
    route), its FMA kernel, its plain version and the library calls that
    compute the same stage (a complex64 ``torch.matmul``; for stage 1 also
    one real fp32 GEMM of the stacked (wr; wi) against the quantized A),
    with the stage's operations (``products``: those of its GEMMs, three
    TF32 ones each on the tensor-core route) and bytes."""
    rng = np.random.default_rng(SEED + 3)
    m = k = n = SIDE
    wr, wi = od.dft_matrix_factors(k, device=dev)
    a = rng_frames(rng, (b, k, n), dev)
    tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=8)
    q = torch.round(torch.clamp(a, 0.0, 1.0) * 255) / 255
    wc, qc, tc = torch.complex(wr, wi), q.to(torch.complex64), \
        torch.complex(tr, ti)
    w_stacked = torch.cat([wr, wi])
    o1, o2 = torch.empty_like(tr), torch.empty_like(tr)
    f4 = 4  # bytes per float32
    return {
        "dft_stage1_batched": dict(
            kernel=lambda: od.dft_stage1_batched(wr, wi, a, dac_bits=8),
            fma=entry(od, 1, b, (wr, wi, a), (o1, o2), route=0),
            plain=lambda: od.dft_stage1_batched_plain(wr, wi, a, dac_bits=8),
            library=lambda: torch.matmul(wc, qc),
            library_real_gemm=lambda: torch.matmul(w_stacked, q),
            flops=4 * b * m * k * n, products=4 * b * m * k * n,
            bytes=f4 * (2 * m * k + b * k * n + 2 * b * m * n)),
        "dft_stage2_batched": dict(
            kernel=lambda: od.dft_stage2_batched(tr, ti, wr, wi),
            fma=entry(od, 2, b, (tr, ti, wr, wi), (o1,), route=0),
            plain=lambda: od.dft_stage2_batched_plain(tr, ti, wr, wi),
            library=lambda: torch.matmul(tc, wc.T),
            flops=8 * b * m * k * n + 3 * b * m * n,
            products=8 * b * m * k * n,
            bytes=f4 * (2 * b * m * k + 2 * n * k + b * m * n)),
    }


TIMED = ("kernel", "fma", "plain", "library", "library_real_gemm")


def time_stage(w: dict) -> dict:
    """CUDA-event medians of each call, in turns (forward then backward
    through the list, each pair averaged) so that drift hits all alike,
    and the profiler's device time per call beside them: at batch 1 and
    2 the host's launch path, not the card, sets the event-timed wall."""
    calls = [c for c in TIMED if c in w]
    ms = {c: [] for c in calls}
    for c in calls + calls[::-1]:
        ms[c].append(median_ms(w[c]))
    out = {}
    for c in calls:
        out[c + "_ms"] = statistics.mean(ms[c])
        out[c + "_device_ms"] = device_ms(w[c])[0]
    bytes_ms = w["bytes"] / PEAK_BYTES_S * 1e3
    out["bound_fma_ms"] = max(w["flops"] / PEAK_FP32_FLOPS * 1e3, bytes_ms)
    if out["kernel_device_ms"]:   # the GEMMs' fp32-accurate rate
        out["tflops"] = w["products"] / out["kernel_device_ms"] / 1e9
    tf32_ms = 3 * w["products"] / PEAK_TF32_FLOPS * 1e3
    out["bound_3xtf32_ms"] = max(tf32_ms, bytes_ms)
    out["bound_3xtf32_by"] = "operations" if tf32_ms >= bytes_ms else "bytes"
    return out


def split_scan(od, dev) -> list[dict]:
    """Device time of each stage's tensor-core kernel at batch 1, 2 and 16
    with the contraction split 1, 2 and 4 ways (the wrappers split 512^3
    frames 2 ways, ``od.tc_split``), and stage 1 with the DAC off."""
    rng = np.random.default_rng(SEED + 6)
    wr, wi = od.dft_matrix_factors(SIDE, device=dev)
    rows = []
    for b in (1, 2, FRAMES):
        a = rng_frames(rng, (b, SIDE, SIDE), dev)
        tr, ti = od.dft_stage1_batched(wr, wi, a, dac_bits=8)
        o1, o2 = torch.empty_like(tr), torch.empty_like(tr)
        for split in (1, 2, 4):
            s1 = device_ms(entry(od, 1, b, (wr, wi, a), (o1, o2), 1,
                                 split))[0]
            s2 = device_ms(entry(od, 2, b, (tr, ti, wr, wi), (o1,), 1,
                                 split))[0]
            rows.append({"batch": b, "split": split, "stage1_device_ms": s1,
                         "stage2_device_ms": s2})
        no_dac = device_ms(entry(od, 1, b, (wr, wi, a), (o1, o2), 1,
                                 od.tc_split(1, SIDE, SIDE, SIDE),
                                 levels=0))[0]
        rows.append({"batch": b, "split": od.tc_split(1, SIDE, SIDE, SIDE),
                     "stage1_no_dac_device_ms": no_dac})
    for r in rows:
        print("  split scan: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items()))
    return rows


def phase_times(od, dev, main: dict, errs: dict[str, float]) -> list[dict]:
    """Both stages at batch 1 (serving's aux frames), the flush's tile_k
    and 16 (one flush group): the tensor-core route, the FMA kernel, the
    plain version and the library calls, with both bounds."""
    batches = sorted({1, main["tile_k"], FRAMES})
    timed = {b: {name: time_stage(w)
                 for name, w in stage_work(od, dev, b).items()}
             for b in batches}
    rows = []
    for name in ("dft_stage1_batched", "dft_stage2_batched"):
        by_batch = [dict(batch=b, **timed[b][name]) for b in batches]
        for r in by_batch:
            print(f"  {name} ({r['batch']}, {SIDE}, {SIDE}, {SIDE}): "
                  + ", ".join(f"{c} {r[c + '_ms']:.4f} ms (device "
                              f"{r[c + '_device_ms'] or float('nan'):.4f})"
                              for c in TIMED if c + "_ms" in r)
                  + f"; bounds 3xTF32 {r['bound_3xtf32_ms']:.4f}, FMA "
                  f"{r['bound_fma_ms']:.4f} ms")
        top = by_batch[-1]
        # the quicker of the single calls that compute the stage
        library = min((c for c in ("library", "library_real_gemm")
                       if c + "_ms" in top), key=lambda c: top[c + "_ms"])
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": main["launches"][name],
            "launches_by_route": main["launches_by_route"][name],
            "max_abs_err": errs[name],
            "ms": top["kernel_ms"], "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_3xtf32_ms"],
            "bound_by": top["bound_3xtf32_by"],
            "library_ms": top[library + "_ms"], "library_call": library,
            "shape": [FRAMES, SIDE, SIDE, SIDE],
            "fma_ms": top["fma_ms"], "bound_fma_ms": top["bound_fma_ms"],
            "by_batch": by_batch,
        })
    rows[0]["split_scan"] = split_scan(od, dev)
    return rows


# --- phase 5: the serving path ---------------------------------------------------


class CheckedLM:
    """The engine's model with every logit checked for finiteness on the
    card (one flag, read once at the end, so no step waits on it)."""

    def __init__(self, model, dev):
        self.model = model
        self.finite = torch.ones((), dtype=torch.bool, device=dev)

    def _check(self, logits):
        self.finite &= torch.isfinite(logits).all()

    def prefill(self, params, batch, *, max_len):
        cache, logits = self.model.prefill(params, batch, max_len=max_len)
        self._check(logits)
        return cache, logits

    def decode_step(self, params, cache, tokens):
        logits, cache = self.model.decode_step(params, cache, tokens)
        self._check(logits)
        return logits, cache


def lanes(cache: dict, n: int) -> dict:
    """A 1-lane decode cache repeated onto n lanes (``pos``, an
    encoder-decoder's ``enc_out`` and a prefix or tail layer's leaves have
    the lane first, a stacked layer's the lane second)."""
    out = {"pos": cache["pos"].repeat(n)}
    if "enc_out" in cache:
        out["enc_out"] = cache["enc_out"].repeat_interleave(n, dim=0)
    for section in ("prefix", "stack", "tail"):
        dim = 1 if section == "stack" else 0
        if section in cache:
            out[section] = {key: {k: t.repeat_interleave(n, dim=dim)
                                  for k, t in layer.items()}
                            for key, layer in cache[section].items()}
    return out


def offline_greedy(model, params, prompt, new, n_lanes, dev,
                   max_len: int = MAX_LEN, extra: dict | None = None,
                   ) -> list[int]:
    """One prompt's prefill (with ``extra``, its frames or patches at
    batch 1) followed by a greedy-decode loop, outside the engine.  The
    prefilled cache is repeated onto ``n_lanes`` identical lanes so that
    every product has the engine's shapes: cuBLAS picks its kernel by
    shape, and a 1-row and a 4-row bf16 product may round differently."""
    cache, logits = model.prefill(
        params, {"tokens": torch.tensor([prompt], device=dev),
                 **(extra or {})}, max_len=max_len)
    cache = lanes(cache, n_lanes)
    toks = [int(torch.argmax(logits[0]))]
    for _ in range(new - 1):
        lg, cache = model.decode_step(
            params, cache, torch.full((n_lanes, 1), toks[-1], device=dev))
        top = torch.argmax(lg, dim=-1).tolist()
        check(len(set(top)) == 1, f"identical lanes decoded {top}")
        toks.append(top[0])
    return toks


def attn_inputs(rng, bh, l, d, groups, dtype, dev, lk=None):
    """q (bh, l, d) and k, v (bh // groups, lk, d), lk l when None."""
    lk = l if lk is None else lk
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(device=dev, dtype=dtype)
        for shape in ((bh, l, d), (bh // groups, lk, d),
                      (bh // groups, lk, d)))


def check_attention(la, dev, lens) -> float:
    """Kernel 6 against its plain version on the card: every (1, 32, L, 64)
    bf16 causal shape the serving run launched, and f32, GQA and windowed
    cases.  Returns the max |err| of the bf16 causal shapes.

    Both sides compute in fp32 from the same inputs; in f32 they differ by
    summation order only (2e-5).  In bf16 they differ by at most the final
    rounding, one bf16 ulp (2^-7 relative), so rtol 1e-2 / atol 1e-3 holds
    them to that and would catch a wrong bf16 load or store."""
    rng = np.random.default_rng(SEED + 5)
    err_bf16 = 0.0
    cases = [(32, l, 64, 1, torch.bfloat16, True, 0) for l in lens]
    cases += [(32, 1000, 64, 1, torch.float32, True, 0),
              (32, 517, 64, 4, torch.float32, True, 0),
              (32, 777, 64, 1, torch.float32, True, 256),
              (16, 333, 128, 2, torch.float32, False, 64),
              (32, 1023, 64, 8, torch.bfloat16, True, 200),
              (16, 333, 128, 2, torch.bfloat16, False, 64)]
    # every head dim the reference's kernel takes up to 256: the FMA route
    # between and at its buckets in f32 and float16, the tensor-core route
    # at D 192 and 256 with GQA
    cases += [(16, 1000, d, 2, dt, True, 0) for d in (48, 80, 192, 256)
              for dt in (torch.float32, torch.float16)]
    cases += [(24, 1023, 192, 12, torch.bfloat16, True, 0),
              (16, 1000, 256, 16, torch.bfloat16, True, 0),
              (16, 777, 256, 4, torch.bfloat16, False, 200)]
    for bh, l, d, g, dtype, causal, window in cases:
        q, k, v = attn_inputs(rng, bh, l, d, g, dtype, dev)
        la.reset_launches()
        got = la.local_flash_attention(q, k, v, causal=causal, window=window,
                                       kv_groups=g)
        want = la.local_flash_attention_plain(q, k, v, causal=causal,
                                              window=window, kv_groups=g)
        torch.cuda.synchronize()
        check(la.local_flash_attention.launches_by_route[la.route(dtype, d)]
              == 1, f"attention ({bh}, {l}, {d}) {dtype} not launched on "
              f"its route {la.route(dtype, d)}")
        rtol, atol = {torch.float32: (2e-5, 2e-5),
                      torch.float16: (2e-3, 1e-3)}.get(dtype, (1e-2, 1e-3))
        err = float((got.float() - want.float()).abs().max())
        check(max_violation(got.float(), want.float(), rtol, atol) <= 0.0,
              f"attention ({bh}, {l}, {d}) groups {g} {dtype} causal "
              f"{causal} window {window}: max |err| {err:.3e} outside rtol "
              f"{rtol} / atol {atol}")
        if dtype == torch.bfloat16 and g == 1 and window == 0 and d == 64:
            err_bf16 = max(err_bf16, err)
    # a misaligned operand of the tensor-core route is copied once and
    # launched there
    buf = torch.from_numpy(rng.standard_normal(24 * 517 * 192 + 1).astype(
        np.float32)).to(device=dev, dtype=torch.bfloat16)
    q = buf[1:].view(24, 517, 192)
    k, v = (torch.randn_like(q[:2]) for _ in range(2))
    la.reset_launches()
    got = la.local_flash_attention(q, k, v, kv_groups=12)
    want = la.local_flash_attention_plain(q, k, v, kv_groups=12)
    torch.cuda.synchronize()
    check(la.local_flash_attention.realigned == 1
          and la.local_flash_attention.launches_by_route ==
          {"tensor_core": 1, "fma": 0}
          and max_violation(got.float(), want.float(), 1e-2, 1e-3) <= 0.0,
          f"misaligned D-192 operand: realigned "
          f"{la.local_flash_attention.realigned}, routes "
          f"{la.local_flash_attention.launches_by_route}")
    print(f"  attention kernel vs plain: {len(cases)} shapes ok (bf16 "
          f"causal at L = {sorted(lens)}, max |err| {err_bf16:.3e}, at rtol "
          "1e-2 / atol 1e-3; f32, GQA and windowed at 2e-5; bf16 at D 128, "
          "192 and 256 and bf16 GQA at 1e-2 / 1e-3; the FMA route at D 48, "
          "80, 192 and 256 in f32 at 2e-5 and float16 at 2e-3 / 1e-3); a "
          "misaligned D-192 operand realigned once on the tensor-core "
          "route (D past 256: phase 12d)")
    return err_bf16


def serve_requests(rt, od, la, dev, cfg, prompt_lens=PROMPT_LENS,
                   max_len: int = MAX_LEN) -> tuple:
    """``cfg`` at random weights from SEED serving 8 requests of
    ``prompt_lens`` tokens through ``ServingEngine`` (SLOTS slots of
    ``max_len``) with AUX_FRAMES fft frames on its ``OffloadScheduler``,
    every kernel's count set to 0 just before and read just after; then
    its checks: one tensor-core launch of kernel 6 per attention layer
    and prefill, the aux
    frames through the DFT kernels' tensor-core route and within 2e-4*max
    + one ADC step of the host, finite logits, and the tokens of
    OFFLINE_RIDS equal to an offline greedy loop.  Returns (engine,
    requests, the run's numbers)."""
    from repro_torch.models import init_params, param_counts
    from repro_torch.models.params import leaves
    from repro_torch.serving import Request, ServingEngine

    arch = cfg.name
    gc.collect()             # an earlier model's engine, cycles included
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    ex = rt.OffloadExecutor(rt.BATCHED_4F, device="cuda")
    sched = rt.OffloadScheduler(ex)
    engine = ServingEngine(cfg, params, batch_slots=SLOTS, max_len=max_len,
                           offload=sched)
    engine.model = CheckedLM(engine.model, dev)
    torch.cuda.synchronize()
    weight_gb = sum(t.numel() * t.element_size()
                    for _, t in leaves(params)) / 1e9
    init_s = time.perf_counter() - t0
    print(f"  {arch}: {param_counts(cfg)[0]:,} parameters ({weight_gb:.2f} "
          f"GB of weights), init + load {init_s:.2f} s, "
          f"{held_gb:.2f} GB held before it")

    # warm-up request (cuBLAS handles, the kernel library), not counted
    engine.submit(Request(rid=-1, prompt=list(range(1, 101)),
                          max_new_tokens=2))
    engine.run_to_completion()
    torch.cuda.synchronize()

    rng = np.random.default_rng(SEED + 4)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, n).tolist(),
                    max_new_tokens=MAX_NEW)
            for i, n in enumerate(prompt_lens)]
    frames = [rng_frames(rng, (SIDE, SIDE), dev) for _ in range(AUX_FRAMES)]
    torch.cuda.synchronize()

    od.reset_launches()
    la.reset_launches()
    t_submit = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    aux, ttft, decode_steps, steps = [], {}, [], 0
    while engine.queue or engine.active:
        if steps % 2 == 0 and len(aux) < AUX_FRAMES:
            aux.append(engine.submit_aux("fft", frames[len(aux)],
                                         backend="optical-sim"))
        before = {r.rid: len(r.out_tokens) for r in reqs}
        t0 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        new = {r.rid: len(r.out_tokens) - before[r.rid] for r in reqs}
        first = [rid for rid, n in new.items() if n and not before[rid]]
        for rid in first:
            ttft[rid] = t1 - t_submit
        if not first:
            decode_steps.append((t1 - t0, sum(new.values())))
        steps += 1
    sched.flush()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t_submit
    launches = {"local_flash_attention": la.local_flash_attention.launches,
                "local_flash_attention_by_route":
                    dict(la.local_flash_attention.launches_by_route),
                "dft_stage1_batched": od.dft_stage1_batched.launches,
                "dft_stage2_batched": od.dft_stage2_batched.launches,
                "dft_by_route": {
                    name: dict(getattr(od, name).launches_by_route)
                    for name in ("dft_stage1_batched",
                                 "dft_stage2_batched")}}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(f"  served {len(reqs)} requests in {steps} steps, {wall_s:.3f} s; "
          f"launches {launches}; peak memory {peak_gb:.2f} GB")

    n_attn = cfg.layer_kinds().count("attn")
    check(launches["local_flash_attention"] == n_attn * len(reqs),
          f"attention kernel launched {launches['local_flash_attention']} "
          f"times for {len(reqs)} prefills of {n_attn} attention layers")
    check(launches["local_flash_attention_by_route"] ==
          {"tensor_core": n_attn * len(reqs), "fma": 0},
          "serving's attention did not all take the tensor-core route: "
          f"{launches['local_flash_attention_by_route']}")
    for name in ("dft_stage1_batched", "dft_stage2_batched"):
        check(launches[name] > 0, f"{name} not launched under serving")
        check(launches["dft_by_route"][name] ==
              {"tensor_core": launches[name], "fma": 0},
              f"{name}: an aux launch left the tensor-core route: "
              f"{launches['dft_by_route'][name]}")
    check(all(r.done and len(r.out_tokens) == MAX_NEW for r in reqs),
          "a request did not return max_new_tokens tokens")
    check(bool(engine.model.finite), "non-finite logits")

    hosts = [ex.submit("fft", f, backend="host") for f in frames]
    ex.flush()
    levels = (1 << rt.BATCHED_4F.adc.bits) - 1
    for i, (h, r) in enumerate(zip(aux, hosts)):
        got, want = h.get(), r.value
        bound = 2e-4 * float(want.max()) + float(got.max()) / levels
        check(h.backend == "optical-sim" and got.shape == (SIDE, SIDE)
              and float((got - want).abs().max()) <= bound,
              f"aux frame {i}: backend {h.backend} or |optical - host| "
              "outside 2e-4*max + one ADC step")
    print(f"  {len(aux)} aux fft frames on optical-sim within 2e-4*max + "
          "one ADC step of host")
    # the DFT kernels against their plain versions at every batch the aux
    # hook dispatched them at under serving
    aux_batches = sorted({h.batch for h in aux})
    check(all(b >= 1 for b in aux_batches), f"aux batches {aux_batches}")
    krng = np.random.default_rng(SEED + 7)
    for b in aux_batches:
        shape = (b, SIDE, SIDE, SIDE)
        e1 = check_stage1(od, krng, shape, dev)
        e2 = check_stage2(od, krng, shape, dev)
        print(f"  stage 1/2 at the aux batch {shape}: max |err| {e1:.3e} / "
              f"{e2:.3e}")

    model = engine.model.model
    for rid in OFFLINE_RIDS:
        req = reqs[rid]
        want = offline_greedy(model, engine.params, req.prompt, MAX_NEW,
                              SLOTS, dev, max_len)
        check(req.out_tokens == want, f"request {rid}: engine tokens "
              f"{req.out_tokens} != offline greedy {want}")
    single = offline_greedy(model, engine.params, reqs[OFFLINE_RIDS[0]].prompt,
                            MAX_NEW, 1, dev, max_len)
    print(f"  engine tokens == offline prefill + greedy decode for requests "
          f"{list(OFFLINE_RIDS)}; at 1 lane the offline tokens "
          f"{'also agree' if single == reqs[OFFLINE_RIDS[0]].out_tokens else 'differ'}")
    ex.close()

    ttfts = [ttft[r.rid] * 1e3 for r in reqs]
    dec_s = sum(t for t, _ in decode_steps)
    dec_tokens = sum(n for _, n in decode_steps)
    step_ms = [t * 1e3 for t, _ in decode_steps]
    out = {"arch": arch, "n_layers": cfg.n_layers, "slots": SLOTS,
           "max_len": max_len, "max_new_tokens": MAX_NEW,
           "prompt_lens": list(prompt_lens), "steps": steps,
           "wall_s": wall_s, "launches": launches,
           "aux_batches": aux_batches,
           "ttft_ms": ttfts, "ttft_ms_median": statistics.median(ttfts),
           "decode_steps": len(decode_steps),
           "decode_step_ms_median": statistics.median(step_ms),
           "decode_tokens_per_s": dec_tokens / dec_s,
           "peak_memory_gb": peak_gb, "held_before_gb": held_gb,
           "weight_gb": weight_gb, "init_s": init_s,
           "offline_single_lane_agrees": single ==
           reqs[OFFLINE_RIDS[0]].out_tokens}
    print(f"  time to first token (ms, from submit): "
          f"{', '.join(f'{t:.1f}' for t in ttfts)}; decode "
          f"{out['decode_tokens_per_s']:.1f} tok/s over {len(decode_steps)} "
          f"steps without a prefill, median step "
          f"{out['decode_step_ms_median']:.3f} ms")
    return engine, reqs, out


def phase_serving(rt, od, la, dev) -> dict:
    from repro_torch import configs

    cfg = configs.get_config(ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.d_ff,
           cfg.vocab_size) == (24, 2048, 32, 64, 5632, 100352),
          f"{ARCH} is not at full width and depth")
    engine, reqs, out = serve_requests(rt, od, la, dev, cfg)
    model = engine.model.model

    def decode() -> float:
        tokens = torch.tensor([[t] for t in engine.last_token], device=dev)
        t0 = time.perf_counter()
        model.decode_step(engine.params, engine.cache, tokens)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def prefill() -> float:
        toks = torch.tensor([reqs[2].prompt], device=dev)
        t0 = time.perf_counter()
        model.prefill(engine.params, {"tokens": toks}, max_len=MAX_LEN)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    # after the counted run: the engine's cache is spent, and launches here
    # do not count
    n = len(reqs[2].prompt)
    unprofiled = {"decode_step_ms": [decode() for _ in range(5)],
                  "prefill_ms": [prefill() for _ in range(3)],
                  "prefill_tokens": n}
    profiled = {"decode_step": profile_flush(decode, "decode step (4 lanes)"),
                "prefill": profile_flush(prefill, f"prefill ({n} tokens)")}
    print(f"  unprofiled: decode step {unprofiled['decode_step_ms']} ms, "
          f"prefill of {n} tokens {unprofiled['prefill_ms']} ms")

    out.update(unprofiled=unprofiled, profiled=profiled)
    return out


def attention_times(la, dev, serving: dict, err: float) -> dict:
    """Kernel 6 at (1, 32, L, 64) bf16 causal for L in ATTN_TIMED_LENS
    (``attention_case``: kernel, plain version, SDPA and the bound), and
    the host cost of its TMA descriptors."""
    rows = {l: attention_case(la, dev, 32, 32, l, 64)
            for l in ATTN_TIMED_LENS}
    bh, l, d = 32, max(ATTN_TIMED_LENS), 64
    q, k, v = attn_inputs(np.random.default_rng(SEED + 6), bh, l, d, 1,
                          torch.bfloat16, dev)
    # the host cost of the tensor-core forward's three TMA descriptors, per
    # forward call, at the serving shape
    reps = 10000
    t0 = time.perf_counter()
    code = la._lib().local_attention_encode_descriptors(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bh, l, l, d, 1, reps)
    encode_us = (time.perf_counter() - t0) / reps * 1e6
    check(code == 0, f"descriptor encoding failed with CUDA error {code}")
    print(f"  TMA descriptor encoding on the host: {encode_us:.3f} us per "
          "forward call (3 descriptors)")
    top = rows[max(ATTN_TIMED_LENS)]
    return {"name": "local_flash_attention", "route": "cuda",
            "source": ATTN_SOURCE,
            "replaces": REPLACES["local_flash_attention"],
            "launches": serving["launches"]["local_flash_attention"],
            "max_abs_err": err, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "shape": [1, 32, max(ATTN_TIMED_LENS), 64],
            "dtype": "bfloat16", "causal": True,
            "kernel_route": la.route(torch.bfloat16, 64),
            "descriptor_encode_us": encode_us,
            "at": {str(l): rows[l] for l in ATTN_TIMED_LENS}}


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time (ms) the card could take for ``flops`` bf16 tensor
    operations moving ``nbytes``, and which of the two bounds it."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def attention_case(la, dev, h: int, hkv: int, l: int, d: int, *,
                   lk: int | None = None, causal: bool = True,
                   dv: int | None = None, window: int = 0,
                   backward: bool = False) -> dict:
    """Kernel 6 at one (1, h, l, d) bf16 attention on hkv KV heads of
    ``lk`` keys (l when None; Lq != Lk only without ``causal``, whose
    masks assume aligned positions), V of ``dv`` columns (d when None; the
    wrapper pads V to d on the card): held to its plain version (forward
    at rtol 1e-2 / atol 1e-3, the backward within 2e-2 * max|plain| and
    bit-equal on a repeat), then timed beside the plain version and one
    ``scaled_dot_product_attention(..., is_causal=causal,
    enable_gqa=True)`` call (the library yardstick; the port never calls
    it), with the bound from this shape's visible pairs and its true V
    width."""
    import torch.nn.functional as F
    lk = l if lk is None else lk
    check(lk == l or not causal, "a causal case needs Lq == Lk")
    rng = np.random.default_rng(SEED + 10 + d)
    g = h // hkv
    q, k, v = attn_inputs(rng, h, l, d, g, torch.bfloat16, dev, lk)
    dv = d if dv is None else dv
    v = v[..., :dv].contiguous()
    kw = dict(causal=causal, window=window, kv_groups=g)
    la.reset_launches()
    got = la.local_flash_attention(q, k, v, **kw)
    want = la.local_flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(la.local_flash_attention.launches_by_route ==
          {"tensor_core": 1, "fma": 0} and got.shape == want.shape
          and max_violation(got.float(), want.float(), 1e-2, 1e-3) <= 0.0,
          f"attention ({h}/{hkv}, {l}, Lk {lk}, {d}, Dv {dv}) bf16: route "
          f"{la.local_flash_attention.launches_by_route}, max |err| "
          f"{err:.3e} outside rtol 1e-2 / atol 1e-3")
    q4, k4, v4 = (t.unsqueeze(0) for t in (q, k, v))
    scale = d ** -0.5
    kern = lambda: la.local_flash_attention(q, k, v, **kw)
    plain = lambda: la.local_flash_attention_plain(q, k, v, **kw)
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                 is_causal=causal,
                                                 enable_gqa=True)
    t = [median_ms(kern), median_ms(plain), median_ms(plain), median_ms(kern)]
    banded = bool(window and window < l)
    if banded:
        # SDPA's causal mask has no window: the band as a boolean mask, on
        # KV heads expanded to the query heads (made before timing)
        band = la._mask(l, l, True, window, dev)
        kx, vx = (x.repeat_interleave(g, dim=0).unsqueeze(0)
                  for x in (k, v))
        lib = lambda: F.scaled_dot_product_attention(q4, kx, vx,
                                                     attn_mask=band)
    vis = (sum(min(i + 1, window) if window else i + 1 for i in range(l))
           if causal else l * lk)
    flops = 2 * vis * h * (d + dv)          # QK^T and PV over visible pairs
    nbytes = 2 * (l * h + lk * hkv) * (d + dv)   # q, out and k, v in bf16
    b_ms, b_by = bound(flops, nbytes)
    row = {"shape": [h, hkv, l, d], "lk": lk, "dv": dv, "dtype": "bfloat16",
           "causal": causal,
           "window": window, "kernel_route": la.route(torch.bfloat16, d),
           "max_abs_err": err, "ms": statistics.mean((t[0], t[3])),
           "plain_ms": statistics.mean((t[1], t[2])),
           "library_ms": median_ms(lib),
           "library_mask": ("band" if banded
                            else "causal" if causal else "no"),
           "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
           "bytes": nbytes}
    if dv != d:   # the work the kernel does on V padded to d columns
        row["padded_bound_ms"] = bound(4 * vis * h * d,
                                       4 * (l * h + lk * hkv) * d)[0]
    row["library_backend"], row["library_kernels"] = sdpa_backend(lib)
    if backward:
        dout = torch.from_numpy(rng.standard_normal(want.shape).astype(
            np.float32)).to(device=dev, dtype=torch.bfloat16)
        if dv == d:
            out, lse = la._forward(q, k, v, scale, window, causal, g,
                                   with_lse=True)
            kern_b = lambda: la._backward(q, k, v, out, lse, dout, scale,
                                          window, causal, g)
        else:   # through the wrapper, which pads V and slices the output
            qk, kk, vk = (x.detach().requires_grad_() for x in (q, k, v))
            k_out = la.local_flash_attention(qk, kk, vk, **kw)
            kern_b = lambda: torch.autograd.grad(k_out, (qk, kk, vk), dout,
                                                 retain_graph=True)
        grads, again = kern_b(), kern_b()
        plain_g = attn_grads(lambda *a: la.local_flash_attention_plain(
            *a, **kw), q, k, v, dout)[1:]
        torch.cuda.synchronize()
        errs = []
        for name, a, b, c in zip(("dq", "dk", "dv"), grads, plain_g, again):
            e = float((a.float() - b.float()).abs().max())
            top = float(b.float().abs().max())
            check(e <= 2e-2 * top and torch.equal(a, c),
                  f"attention backward {name} ({h}/{hkv}, {l}, {d}): max "
                  f"|err| {e:.3e} > 2e-2 * {top:.3e} or not bit-equal on a "
                  "repeat")
            errs.append(e)
        qp, kp, vp = (x.detach().requires_grad_() for x in (q, k, v))
        p_out = la.local_flash_attention_plain(qp, kp, vp, **kw)
        q4g, k4g, v4g = (x.unsqueeze(0).detach().requires_grad_()
                         for x in (q, k, v))
        if banded:   # the band mask on KV heads expanded in the graph
            l_out = F.scaled_dot_product_attention(
                q4g, k4g.repeat_interleave(g, dim=1),
                v4g.repeat_interleave(g, dim=1), attn_mask=band)
        else:
            l_out = F.scaled_dot_product_attention(q4g, k4g, v4g,
                                                   is_causal=causal,
                                                   enable_gqa=True)
        plain_b = lambda: torch.autograd.grad(p_out, (qp, kp, vp), dout,
                                              retain_graph=True)
        lib_b = lambda: torch.autograd.grad(l_out, (q4g, k4g, v4g),
                                            dout.unsqueeze(0),
                                            retain_graph=True)
        tb = [median_ms(kern_b), median_ms(plain_b), median_ms(plain_b),
              median_ms(kern_b)]
        # S recomputed and dQ, dK (at d), dV and dP (at dv); q, k, v,
        # out, dout and lse read, dq, dk, dv written
        bb_ms, bb_by = bound(2 * vis * h * (3 * d + 2 * dv), 2 * nbytes
                             + 4 * h * l)
        row["backward"] = {
            "max_abs_err": max(errs), "ms": statistics.mean((tb[0], tb[3])),
            "plain_ms": statistics.mean((tb[1], tb[2])),
            "library_ms": median_ms(lib_b), "bound_ms": bb_ms,
            "bound_by": bb_by}
    print(f"  kernel 6 at ({h} q / {hkv} KV heads, L {l}"
          f"{f', Lk {lk}' if lk != l else ''}, D {d}"
          f"{f', Dv {dv}' if dv != d else ''}) bf16 "
          f"{'causal' if causal else 'non-causal'}"
          f"{f' window {window}' if window else ''}: forward "
          f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f}, SDPA "
          f"{row['library_ms']:.4f} ({row['library_backend']}, "
          f"{row['library_mask']} mask), bound {b_ms:.4f} ({b_by})"
          + (f", padded {row['padded_bound_ms']:.4f}" if dv != d else "")
          + f"; max |err| "
          f"{err:.3e}" + ("" if not backward else
                          f"; backward {row['backward']['ms']:.4f} ms, plain "
                          f"{row['backward']['plain_ms']:.4f}, SDPA "
                          f"{row['backward']['library_ms']:.4f} "
                          f"({row['library_backend']}), bound "
                          f"{bb_ms:.4f} ({bb_by})"))
    return row


# --- phase 6: the training path ----------------------------------------------


def attn_grads(fn, q, k, v, dout):
    """(out, dq, dk, dv) of ``fn`` at fresh leaves made from q, k, v."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return out.detach(), q.grad, k.grad, v.grad


def check_attention_backward(la, dev) -> float:
    """Kernel 6's backward against the plain version's autograd on the
    card: the (128, 1024, 64) bf16 causal shape every training step
    launched (within 2e-2 * max|plain|: the kernel takes its row sums
    dO . O from the bf16-rounded output), and f32, GQA and windowed cases
    (within 1e-4 * max|plain|: summation order only); then two launches
    on the same inputs must give bit-equal gradients.  Returns the max
    |err| of the training shape."""
    rng = np.random.default_rng(SEED + 8)
    bh = TRAIN_BATCH * 32
    cases = [(bh, TRAIN_SEQ, 64, 1, torch.bfloat16, True, 0, 2e-2),
             (32, 1000, 64, 1, torch.float32, True, 0, 1e-4),
             (32, 517, 64, 4, torch.float32, True, 0, 1e-4),
             (32, 777, 64, 1, torch.float32, True, 256, 1e-4),
             (16, 333, 128, 2, torch.float32, False, 64, 1e-4),
             (32, 1023, 64, 8, torch.bfloat16, True, 200, 2e-2),
             (48, 1024, 192, 12, torch.bfloat16, True, 0, 2e-2),
             (16, 1000, 256, 16, torch.bfloat16, True, 0, 2e-2),
             (16, 517, 192, 2, torch.float32, True, 0, 1e-4),
             (16, 333, 256, 1, torch.float32, False, 64, 1e-4),
             (16, 517, 80, 2, torch.float16, True, 0, 2e-2)]
    err_train = 0.0
    for bhq, l, d, g, dtype, causal, window, tol in cases:
        q, k, v = attn_inputs(rng, bhq, l, d, g, dtype, dev)
        dout = torch.from_numpy(rng.standard_normal(q.shape).astype(
            np.float32)).to(device=dev, dtype=dtype)
        kw = dict(causal=causal, window=window, kv_groups=g)
        got = attn_grads(lambda *t: la.local_flash_attention(*t, **kw),
                         q, k, v, dout)
        want = attn_grads(lambda *t: la.local_flash_attention_plain(
            *t, **kw), q, k, v, dout)
        torch.cuda.synchronize()
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            err = float((a.float() - b.float()).abs().max())
            top = float(b.float().abs().max())
            check(a.dtype == dtype and err <= tol * top,
                  f"attention backward {name} ({bhq}, {l}, {d}) groups {g} "
                  f"{dtype} causal {causal} window {window}: max |err| "
                  f"{err:.3e} > {tol} * max|plain| {top:.3e}")
            errs.append(err)
        if (bhq, l, dtype) == (bh, TRAIN_SEQ, torch.bfloat16):
            err_train = max(errs)
        again = attn_grads(lambda *t: la.local_flash_attention(*t, **kw),
                           q, k, v, dout)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"attention backward ({bhq}, {l}, {d}) {dtype}: two launches "
              "on the same inputs differ")
    print(f"  attention backward vs plain autograd: {len(cases)} shapes ok "
          f"(bf16 causal ({bh}, {TRAIN_SEQ}, 64), the training shape: max "
          f"|err| {err_train:.3e} within 2e-2 * max|plain|; f32, GQA and "
          "windowed within 1e-4 * max|plain|; bf16 at D 192 and 256 on the "
          "tensor-core route and float16 at D 80 within 2e-2 * max|plain|, "
          "f32 at D 192 and 256 within 1e-4 * max|plain|); bit-equal on a "
          "repeat launch")
    return err_train


def phase_training(la, dev, card: str) -> dict:
    import shutil
    from repro_torch import configs
    from repro_torch.launch import train as ttrain
    from repro_torch.models import LM, param_counts
    from repro_torch.models.params import leaves
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import loss_and_grads, make_train_step

    cfg = configs.get_config(ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim_, cfg.d_ff,
           cfg.vocab_size) == (24, 2048, 32, 64, 5632, 100352),
          f"{ARCH} is not at full width and depth")
    n_params = param_counts(cfg)[0]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    starts: list[float] = []

    def mark(step: int) -> None:
        # runs at the start of every step; each step ends with the host
        # reading its loss (log_every=1), so the gaps are step walls
        starts.append(time.perf_counter())

    la.reset_launches()
    t0 = time.perf_counter()
    state, losses, task = ttrain.train_loop(
        ARCH, smoke=False, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ, ckpt_dir=str(TRAIN_CKPT), log_every=1, seed=SEED,
        fault_hook=mark, device=dev)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = {"local_flash_attention": la.local_flash_attention.launches,
                "local_flash_attention_backward":
                    la.local_flash_attention.backward_launches,
                "local_flash_attention_by_route":
                    dict(la.local_flash_attention.launches_by_route),
                "local_flash_attention_backward_by_route":
                    dict(la.local_flash_attention.backward_launches_by_route)}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    walls = [b - a for a, b in zip(starts, starts[1:] + [t_end])]
    print(f"  {ARCH}: {n_params:,} parameters, {TRAIN_STEPS} steps of "
          f"{tokens} tokens in {t_end - t0:.2f} s (init included); "
          f"launches {launches}; peak memory {peak_gb:.2f} GB "
          f"({held_gb:.2f} GB held by earlier phases)")

    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"training losses {losses}")
    check(len(walls) == TRAIN_STEPS, f"{len(walls)} step marks")
    check(launches["local_flash_attention"] == 2 * cfg.n_layers * TRAIN_STEPS,
          f"attention forward launched {launches['local_flash_attention']} "
          f"times in {TRAIN_STEPS} steps (want 2 x {cfg.n_layers} a step: "
          "forward and recompute)")
    check(launches["local_flash_attention_backward"]
          == cfg.n_layers * TRAIN_STEPS,
          f"attention backward launched "
          f"{launches['local_flash_attention_backward']} times in "
          f"{TRAIN_STEPS} steps (want {cfg.n_layers} a step)")
    check(launches["local_flash_attention_by_route"] ==
          {"tensor_core": 2 * cfg.n_layers * TRAIN_STEPS, "fma": 0}
          and launches["local_flash_attention_backward_by_route"] ==
          {"tensor_core": cfg.n_layers * TRAIN_STEPS, "fma": 0},
          "training's attention did not all take the tensor-core route: "
          f"{launches}")
    check(not TRAIN_CKPT.exists() or not any(TRAIN_CKPT.iterdir()),
          "the training phase wrote a checkpoint")

    params, opt_state = state
    model = LM(cfg)
    batch = task.batch(TRAIN_STEPS, dev)
    loss, _, grads = loss_and_grads(model, params, batch)
    flat = {"/".join(path): g for path, g in leaves(grads)}
    finite = all(bool(torch.isfinite(g).all()) for g in flat.values())
    check(bool(torch.isfinite(loss)) and finite,
          "a gradient leaf is not finite")
    for name in ("w_q", "w_k", "w_v"):
        g = flat[f"stack/0_attn/attn/{name}"]
        check(all(float(g[i].abs().max()) > 0.0 for i in range(cfg.n_layers)),
              f"{name}: a layer got no gradient")
    print(f"  all {len(flat)} gradient leaves finite; w_q, w_k, w_v nonzero "
          f"in all {cfg.n_layers} layers")
    del grads, flat

    opt = adamw(lambda s: warmup_cosine(s, peak_lr=3e-3,
                                        warmup_steps=TRAIN_STEPS // 10 + 1,
                                        total_steps=TRAIN_STEPS))
    step_fn = make_train_step(model, opt)

    def one_step() -> float:
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch, TRAIN_STEPS)
        float(out[2]["loss"])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    profiled = profile_flush(one_step, "training step")
    timed = walls[1:]
    step_s = statistics.median(timed)
    flops = 6 * n_params * tokens
    out = {"arch": ARCH, "params": n_params, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "losses": losses,
           "step_wall_s": walls, "step_wall_s_median": step_s,
           "tokens_per_s": tokens / step_s,
           "model_flops_per_step": flops,
           "model_tflops": flops / step_s / 1e12,
           "mfu_bf16": flops / step_s / PEAK_BF16_FLOPS,
           "peak_memory_gb": peak_gb, "held_before_gb": held_gb,
           "launches": launches, "profiled_step": profiled}
    print(f"  [{card}] step walls (s) {', '.join(f'{w:.4f}' for w in walls)}"
          f"; median of the 4 timed {step_s:.4f} s, "
          f"{out['tokens_per_s']:.1f} tokens/s")
    print(f"  [{card}] model FLOP/s (6 N T): {out['model_tflops']:.2f} "
          f"TFLOP/s, {100 * out['mfu_bf16']:.2f} % of 989 TFLOP/s bf16; "
          f"peak memory {peak_gb:.2f} GB; device busy share of one profiled "
          f"step {profiled['device_busy_share']}")
    return out


def attention_train_times(la, dev, training: dict, err: float,
                          card: str) -> tuple[dict, dict]:
    """Kernel 6's forward (with its log-sum-exp, as training runs it) and
    its backward at the training shape (128, 1024, 64) bf16 causal: kernel,
    plain version (its autograd for the backward) and one
    ``scaled_dot_product_attention`` forward and backward (the library
    yardstick, timed only), with the bounds.  Returns (forward numbers,
    the backward's kernel row)."""
    import torch.nn.functional as F
    rng = np.random.default_rng(SEED + 9)
    b, h, l, d = TRAIN_BATCH, 32, TRAIN_SEQ, 64
    bh = b * h
    q, k, v = attn_inputs(rng, bh, l, d, 1, torch.bfloat16, dev)
    dout = torch.from_numpy(rng.standard_normal(q.shape).astype(
        np.float32)).to(device=dev, dtype=torch.bfloat16)
    scale = d ** -0.5
    out, lse = la._forward(q, k, v, scale, 0, True, 1, with_lse=True)
    fwd = lambda: la._forward(q, k, v, scale, 0, True, 1, with_lse=True)
    bwd = lambda: la._backward(q, k, v, out, lse, dout, scale, 0, True, 1)
    qp, kp, vp = (t.detach().requires_grad_() for t in (q, k, v))
    plain_out = la.local_flash_attention_plain(qp, kp, vp, causal=True)
    plain_fwd = lambda: la.local_flash_attention_plain(q, k, v, causal=True)
    plain_bwd = lambda: torch.autograd.grad(plain_out, (qp, kp, vp), dout,
                                            retain_graph=True)
    q4, k4, v4 = (t.view(b, h, l, d).detach().requires_grad_()
                  for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    lib_fwd = lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                     is_causal=True)
    lib_bwd = lambda: torch.autograd.grad(lib_out, (q4, k4, v4),
                                          dout.view(b, h, l, d),
                                          retain_graph=True)
    ms = {}
    for name, kern, plain in (("fwd", fwd, plain_fwd), ("bwd", bwd,
                                                        plain_bwd)):
        t = [median_ms(kern), median_ms(plain), median_ms(plain),
             median_ms(kern)]
        ms[name] = statistics.mean((t[0], t[3]))
        ms["plain_" + name] = statistics.mean((t[1], t[2]))
    ms["lib_fwd"] = median_ms(lib_fwd)
    ms["lib_bwd"] = median_ms(lib_bwd)
    flops_f = 2 * bh * l * l * d          # QK^T and PV, causal half each
    flops_b = 5 * flops_f // 2            # dS, dQ, dK, dV and P: 2.5x
    bytes_f = 2 * 4 * bh * l * d + 4 * bh * l          # q k v out + lse
    bytes_b = 2 * 8 * bh * l * d + 4 * bh * l          # + dout, dq dk dv
    bounds = {"fwd": bound(flops_f, bytes_f), "bwd": bound(flops_b, bytes_b)}
    flops = {"fwd": flops_f, "bwd": flops_b}
    for name, label in (("fwd", "forward (with lse)"), ("bwd", "backward")):
        print(f"  [{card}] local_flash_attention {label} ({bh}, {l}, {d}) "
              f"bf16 causal: kernel {ms[name]:.4f} ms "
              f"({flops[name] / ms[name] / 1e9:.1f} TFLOP/s), plain "
              f"{ms['plain_' + name]:.4f} ms, SDPA {ms['lib_' + name]:.4f} "
              f"ms ({flops[name] / ms['lib_' + name] / 1e9:.1f} TFLOP/s), "
              f"bound {bounds[name][0]:.4f} ms ({bounds[name][1]})")
    # the model's call: q, k, v come transposed from (B, S, H, hd), and
    # ops.gqa_flash_attention makes each contiguous before the kernel
    from repro_torch.kernels import ops
    qt, kt, vt = (t.view(b, h, l, d).transpose(1, 2).contiguous()
                  .transpose(1, 2) for t in (q, k, v))
    with torch.no_grad():
        call_ms, by_name = device_ms(lambda: ops.gqa_flash_attention(qt, kt,
                                                                     vt))
    k6 = sum(t for n, t in by_name.items() if is_kernel6(n))
    copies_ms = None if call_ms is None else call_ms - k6
    print(f"  [{card}] ops.gqa_flash_attention on the model's transposed "
          f"operands: device time {call_ms} ms a call, kernel 6 {k6} ms, "
          f"the operands' contiguous copies {copies_ms} ms")
    print(f"  [{card}] forward + backward: kernel "
          f"{ms['fwd'] + ms['bwd']:.4f} ms, SDPA "
          f"{ms['lib_fwd'] + ms['lib_bwd']:.4f} ms")
    fwd_row = {"shape": [bh, l, d], "dtype": "bfloat16", "causal": True,
               "tflops": flops_f / ms["fwd"] / 1e9,
               "call_site_device_ms": call_ms,
               "call_site_copies_ms": copies_ms,
               "ms": ms["fwd"], "plain_ms": ms["plain_fwd"],
               "library_ms": ms["lib_fwd"], "bound_ms": bounds["fwd"][0],
               "bound_by": bounds["fwd"][1],
               "launches": training["launches"]["local_flash_attention"]}
    bwd_row = {"name": "local_flash_attention_backward", "route": "cuda",
               "source": ATTN_SOURCE,
               "replaces": REPLACES["local_flash_attention_backward"],
               "launches": training["launches"][
                   "local_flash_attention_backward"],
               "max_abs_err": err, "ms": ms["bwd"],
               "plain_ms": ms["plain_bwd"], "bound_ms": bounds["bwd"][0],
               "bound_by": bounds["bwd"][1], "library_ms": ms["lib_bwd"],
               "shape": [bh, l, d], "dtype": "bfloat16", "causal": True,
               "kernel_route": la.route(torch.bfloat16, d),
               "tflops": flops_b / ms["bwd"] / 1e9,
               "fwd_plus_bwd_ms": ms["fwd"] + ms["bwd"],
               "library_fwd_plus_bwd_ms": ms["lib_fwd"] + ms["lib_bwd"]}
    return fwd_row, bwd_row


# --- phase 11: dense serving at full width -------------------------------------

# (arch, the layers kept, None for all): nemotron-4-340b's 96 layers would
# be 682 GB of bf16; 4 layers and the untied embed and head are 46.5 GB
DENSE_SERVING = (("qwen2.5-32b", None), ("nemotron-4-340b", 4))
# (layers, d_model, heads, KV heads, head dim, d_ff, vocab) as published
DENSE_WIDTHS = {"qwen2.5-32b": (64, 5120, 40, 8, 128, 27648, 152064),
                "nemotron-4-340b": (96, 18432, 96, 8, 192, 73728, 256000)}
PREFILL_L = 1024         # kernel 6's check and timing: the longest prompt
                         # (1023 tokens) rounded up to whole 64-key tiles


def phase_dense_serving(rt, od, la, dev, card: str) -> dict:
    """qwen2.5-32b at full width and depth and nemotron-4-340b at full
    width on 4 of its 96 layers, each serving phase 5's traffic; kernel 6
    at each model's prefill attention against its plain version."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import param_counts

    out = {}
    for arch, layers in DENSE_SERVING:
        cfg = configs.get_config(arch)
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.head_dim_, cfg.d_ff, cfg.vocab_size) == DENSE_WIDTHS[arch],
              f"{arch} is not at its published width and depth")
        full_params = param_counts(cfg)[0]
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
            print(f"  {arch}: depth cut to {layers} of "
                  f"{DENSE_WIDTHS[arch][0]} layers at full width "
                  f"({param_counts(cfg)[0]:,} of {full_params:,} "
                  "parameters)")
        check(la.route(cfg.activation_dtype, cfg.head_dim_) == "tensor_core",
              f"{arch}'s attention (D {cfg.head_dim_}) is not on kernel 6's "
              "tensor-core route")
        _, _, run = serve_requests(rt, od, la, dev, cfg)
        run["full_params"] = full_params
        run["depth_cut"] = layers
        run["kernel6"] = attention_case(la, dev, cfg.n_heads, cfg.n_kv_heads,
                                        PREFILL_L, cfg.head_dim_,
                                        backward=True)
        print(f"  [{card}] {arch}: TTFT median {run['ttft_ms_median']:.1f} "
              f"ms, decode {run['decode_tokens_per_s']:.1f} tok/s, peak "
              f"memory {run['peak_memory_gb']:.2f} GB, weights "
              f"{run['weight_gb']:.2f} GB")
        out[arch] = run
    return out


# --- phase 12: the recurrent families -------------------------------------------

# recurrentgemma-9b as published: (layers, d_model, heads, KV heads, head
# dim, d_ff, vocab, window, lru_width)
RG_ARCH = "recurrentgemma-9b"
RG_WIDTHS = (38, 4096, 16, 1, 256, 12288, 256000, 2048, 4096)
# 8 prompts of 512-4096 tokens, four past the 2048 window; none a whole
# number of 64-key tiles but 512 and 4096
RG_PROMPT_LENS = (512, 2500, 1031, 4096, 777, 3001, 2049, 1500)
RG_MAX_LEN = 4608
RG_TIMED_L = 4096
# xlstm-125m as published: (layers, d_model, heads, vocab); its training
XL_ARCH = "xlstm-125m"
XL_WIDTHS = (12, 768, 4, 50304)
XL_STEPS, XL_BATCH, XL_SEQ = 20, 8, 128
XL_REMAT = (("full", {}), ("dots", {"REPRO_REMAT_POLICY": "dots"}),
            ("group2", {"REPRO_REMAT_GROUP": "2"}))
XL_CKPT = Path(__file__).resolve().parent / "build" / "chip_smoke_train_lm"
# Adafactor and error feedback at a full-width qwen2.5-32b layer's shapes
OPT_SHAPES = {"w_in": (5120, 27648), "ln": (5120,)}
# kernel 6 past D 256 (the FMA route's wide kernels)
WIDE_DIMS = (257, 320, 512)


def phase_recurrent_serving(rt, od, la, dev, card: str) -> dict:
    """12a: recurrentgemma-9b at its published width and depth serving 8
    prompts of 512-4096 tokens (four past its 2048 window) with
    max_len 4608; kernel 6 at (16 / 1, 4096, 256) window 2048."""
    from repro_torch import configs

    cfg = configs.get_config(RG_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim_, cfg.d_ff, cfg.vocab_size, cfg.local_window,
           cfg.lru_width) == RG_WIDTHS,
          f"{RG_ARCH} is not at its published width and depth")
    check(la.route(cfg.activation_dtype, cfg.head_dim_) == "tensor_core",
          f"{RG_ARCH}'s attention (D {cfg.head_dim_}) is not on kernel 6's "
          "tensor-core route")
    check(sum(n > cfg.local_window for n in RG_PROMPT_LENS) >= 3,
          "fewer than three prompts past the window")
    _, _, run = serve_requests(rt, od, la, dev, cfg, RG_PROMPT_LENS,
                               RG_MAX_LEN)
    ttft = run["ttft_ms"]
    run["ttft_ms_median_by_round"] = [statistics.median(ttft[:SLOTS]),
                                      statistics.median(ttft[SLOTS:])]
    run["kernel6"] = attention_case(la, dev, cfg.n_heads, cfg.n_kv_heads,
                                    RG_TIMED_L, cfg.head_dim_,
                                    window=cfg.local_window)
    print(f"  [{card}] {RG_ARCH}: TTFT median {run['ttft_ms_median']:.1f} ms "
          f"(first round {run['ttft_ms_median_by_round'][0]:.1f}, second "
          f"{run['ttft_ms_median_by_round'][1]:.1f}), decode "
          f"{run['decode_tokens_per_s']:.1f} tok/s (median step "
          f"{run['decode_step_ms_median']:.3f} ms), peak memory "
          f"{run['peak_memory_gb']:.2f} GB, weights {run['weight_gb']:.2f} "
          f"GB; kernel 6 by route "
          f"{run['launches']['local_flash_attention_by_route']}")
    return run


def remat_agreement(model, params, task, dev) -> dict:
    """Two AdamW steps from ``params`` under each remat setting of
    XL_REMAT (the environment switches set around them): the losses and
    every gradient leaf of both steps within 1e-6 relative of "full"'s
    (|diff| <= 1e-6 * max|full| per leaf)."""
    import os
    from repro_torch.models.params import leaves
    from repro_torch.optim import adamw, apply_updates
    from repro_torch.train import loss_and_grads

    opt = adamw(1e-3)
    runs = {}
    for name, env in XL_REMAT:
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            p, st, steps = params, opt.init(params), []
            for i in range(2):
                loss, _, grads = loss_and_grads(model, p,
                                                task.batch(XL_STEPS + i, dev))
                steps.append((float(loss), grads))
                upd, st, _ = opt.update(grads, st, p, i)
                p = apply_updates(p, upd)
            runs[name] = steps
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    worst = {}
    for name, steps in runs.items():
        if name == "full":
            continue
        rel = 0.0
        for (l0, g0), (l1, g1) in zip(runs["full"], steps):
            rel = max(rel, abs(l1 - l0) / abs(l0))
            for (_, a), (_, b) in zip(leaves(g0), leaves(g1)):
                top = float(a.abs().max())
                d = float((b - a).abs().max())
                rel = max(rel, d / top if top else d)
        check(rel <= 1e-6, f"remat {name}: losses or gradients differ from "
              f"full by {rel:.3e} relative (> 1e-6)")
        worst[name] = rel
    losses = {name: [l for l, _ in steps] for name, steps in runs.items()}
    print(f"  remat settings over 2 steps: losses {losses}; worst relative "
          f"difference from full {worst} (<= 1e-6)")
    return {"losses": losses, "max_rel_diff": worst}


def phase_recurrent_training(dev, card: str) -> dict:
    """12b: xlstm-125m at full width and depth, 20 AdamW steps of 8 x 128
    tokens through ``examples/train_lm.py``'s twin (checkpoints under
    build/); losses falling and finite, every gradient leaf finite, the
    remat settings agreeing."""
    import shutil
    from repro_torch import configs
    from repro_torch.examples import train_lm
    from repro_torch.models import LM, param_counts
    from repro_torch.models.params import leaves
    from repro_torch.train import loss_and_grads

    cfg = configs.get_config(XL_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.vocab_size) ==
          XL_WIDTHS, f"{XL_ARCH} is not at its published width and depth")
    n_params = param_counts(cfg)[0]
    tokens = XL_BATCH * XL_SEQ
    shutil.rmtree(XL_CKPT, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    starts: list[float] = []
    t0 = time.perf_counter()
    (params, _), losses, task = train_lm.train(
        steps=XL_STEPS, batch=XL_BATCH, seq=XL_SEQ, ckpt_dir=str(XL_CKPT),
        device=dev, log_every=1,
        fault_hook=lambda step: starts.append(time.perf_counter()))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    walls = [b - a for a, b in zip(starts, starts[1:] + [t_end])]
    check(len(losses) == XL_STEPS and all(np.isfinite(losses)),
          f"training losses {losses}")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses[0]} -> "
          f"{losses[-1]}")
    check(len(walls) == XL_STEPS, f"{len(walls)} step marks")
    written = sorted(p.name for p in XL_CKPT.iterdir()) \
        if XL_CKPT.exists() else []
    model = LM(cfg)
    loss, _, grads = loss_and_grads(model, params, task.batch(XL_STEPS, dev))
    check(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(g).all()) for _, g in leaves(grads)),
          "a gradient leaf is not finite")
    del grads
    remat = remat_agreement(model, params, task, dev)
    step_s = statistics.median(walls[1:])
    out = {"arch": XL_ARCH, "params": n_params, "batch": XL_BATCH,
           "seq": XL_SEQ, "steps": XL_STEPS, "losses": losses,
           "step_wall_s": walls, "step_wall_s_median": step_s,
           "tokens_per_s": tokens / step_s, "peak_memory_gb": peak_gb,
           "held_before_gb": held_gb, "wall_s": t_end - t0,
           "checkpoints": written, "remat": remat}
    print(f"  [{card}] {XL_ARCH}: {n_params:,} parameters, {XL_STEPS} steps "
          f"of {tokens} tokens in {t_end - t0:.2f} s (init and checkpoints "
          f"{written} included); loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"step wall median of the last {XL_STEPS - 1} {step_s:.4f} s, "
          f"{out['tokens_per_s']:.1f} tokens/s; peak memory {peak_gb:.2f} "
          f"GB ({held_gb:.2f} GB held before); every gradient leaf finite")
    return out


def phase_optimizers(dev, card: str) -> dict:
    """12c: one Adafactor step on a factored (5120, 27648) matrix and an
    unfactored (5120,) vector, and one ``ef_compress`` / ``ef_decompress``
    round on the matrix, each on the card and on the CPU from the same
    inputs.  Adafactor's update and state within rtol 1e-5 / atol
    1e-6 * max of the CPU's (reductions in another order); the int8 codes
    and scales equal, the residual and the decompressed gradient within
    1e-6 * the scale."""
    from repro_torch.optim import (adafactor, ef_compress, ef_decompress,
                                   ef_init)

    rng = np.random.default_rng(SEED + 12)
    host = {k: {"p": torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)), "g": torch.from_numpy(rng.standard_normal(sh).astype(
            np.float32) * 1e-2)} for k, sh in OPT_SHAPES.items()}
    res = {}
    for where in ("cpu", dev):
        params = {k: v["p"].to(where) for k, v in host.items()}
        grads = {k: v["g"].to(where) for k, v in host.items()}
        opt = adafactor(1e-2)
        state = opt.init(params)
        upd, state, _ = opt.update(grads, state, params, 0)
        q, scale, resid = ef_compress({"w": grads["w_in"]},
                                      ef_init({"w": grads["w_in"]}))
        back = ef_decompress(q, scale)
        torch.cuda.synchronize()
        res[str(where)] = {"upd": upd, "state": state, "q": q["w"],
                           "scale": scale["w"], "res": resid["w"],
                           "back": back["w"]}
    cpu, card_ = res["cpu"], res[str(dev)]
    check(set(cpu["state"]["v"]["w_in"]) == {"vr", "vc"}
          and set(cpu["state"]["v"]["ln"]) == {"v"},
          "Adafactor did not factor the matrix alone")
    errs = {}
    pairs = [("update " + k, card_["upd"][k], cpu["upd"][k])
             for k in OPT_SHAPES]
    pairs += [(f"state {k}/{n}", card_["state"]["v"][k][n], t)
              for k in OPT_SHAPES for n, t in cpu["state"]["v"][k].items()]
    for name, got, want in pairs:
        got = got.cpu()
        top = float(want.abs().max())
        errs[name] = float((got - want).abs().max())
        check(max_violation(got, want, 1e-5, 1e-6 * top) <= 0.0,
              f"Adafactor {name}: card vs CPU max |err| {errs[name]:.3e}")
    mism = int((card_["q"].cpu() != cpu["q"]).sum())
    check(card_["q"].dtype == torch.int8 and mism == 0
          and float(card_["scale"]) == float(cpu["scale"]),
          f"int8 codes differ at {mism} elements, or the scale "
          f"({float(card_['scale'])} vs {float(cpu['scale'])})")
    sc = float(cpu["scale"])
    for name in ("res", "back"):
        e = float((card_[name].cpu() - cpu[name]).abs().max())
        errs["compression " + name] = e
        check(e <= 1e-6 * sc, f"compression {name}: max |err| {e:.3e} > "
              f"1e-6 * scale {sc:.3e}")
    print(f"  [{card}] Adafactor on (5120, 27648) + (5120,) and an int8 "
          f"error-feedback round on the matrix: card == CPU (max |err| "
          f"{ {k: f'{v:.2e}' for k, v in errs.items()} }; int8 codes and "
          f"scale equal)")
    return {"max_abs_err": errs, "int8_mismatches": mism, "scale": sc}


def phase_wide_head_dims(la, dev, card: str) -> dict:
    """12d: kernel 6 at D 257, 320 and 512 (the FMA route's wide kernels),
    f32 and bf16, causal and windowed, forward and backward against the
    plain version (f32: 2e-5 forward, 1e-4 * max backward; bf16: rtol
    1e-2 / atol 1e-3 forward, 2e-2 * max backward), each forward timed
    beside the plain version, SDPA with the same mask (on KV heads
    expanded to the query heads) and its bound: the visible pairs'
    products at the fp32 rate for f32 inputs, the bf16 rate for bf16."""
    import torch.nn.functional as F
    rng = np.random.default_rng(SEED + 13)
    bh, l, g = 8, 1024, 2
    rows = []
    for d in WIDE_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for window in (0, 300):
                q, k, v = attn_inputs(rng, bh, l, d, g, dtype, dev)
                dout = torch.from_numpy(rng.standard_normal(q.shape).astype(
                    np.float32)).to(device=dev, dtype=dtype)
                kw = dict(causal=True, window=window, kv_groups=g)
                la.reset_launches()
                got = attn_grads(lambda *t: la.local_flash_attention(
                    *t, **kw), q, k, v, dout)
                want = attn_grads(lambda *t: la.local_flash_attention_plain(
                    *t, **kw), q, k, v, dout)
                torch.cuda.synchronize()
                routes = (dict(la.local_flash_attention.launches_by_route),
                          dict(la.local_flash_attention
                               .backward_launches_by_route))
                check(routes == ({"tensor_core": 0, "fma": 1},) * 2,
                      f"D {d} {dtype}: routes {routes}")
                f32 = dtype == torch.float32
                rtol, atol = (2e-5, 2e-5) if f32 else (1e-2, 1e-3)
                err = float((got[0].float() - want[0].float()).abs().max())
                check(max_violation(got[0].float(), want[0].float(), rtol,
                                    atol) <= 0.0,
                      f"D {d} {dtype} window {window}: forward max |err| "
                      f"{err:.3e}")
                tol = 1e-4 if f32 else 2e-2
                berr = 0.0
                for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
                    e = float((a.float() - b.float()).abs().max())
                    top = float(b.float().abs().max())
                    check(e <= tol * top, f"D {d} {dtype} window {window}: "
                          f"{name} max |err| {e:.3e} > {tol} * {top:.3e}")
                    berr = max(berr, e)
                kern = lambda: la.local_flash_attention(q, k, v, **kw)
                plain = lambda: la.local_flash_attention_plain(q, k, v, **kw)
                band = la._mask(l, l, True, window, dev)
                q4, kx, vx = (x.unsqueeze(0) for x in (
                    q, k.repeat_interleave(g, dim=0),
                    v.repeat_interleave(g, dim=0)))
                lib = lambda: F.scaled_dot_product_attention(
                    q4, kx, vx, attn_mask=band if window else None,
                    is_causal=not window)
                t = [median_ms(kern, runs=5), median_ms(plain, runs=5),
                     median_ms(lib, runs=5)]
                vis = sum(min(i + 1, window) if window else i + 1
                          for i in range(l))
                flops = 4 * vis * d * bh
                nbytes = q.element_size() * l * d * (2 * bh + 2 * bh // g)
                peak = PEAK_FP32_FLOPS if f32 else PEAK_BF16_FLOPS
                t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES_S * 1e3
                backend, names = sdpa_backend(lib)
                rows.append({"d": d, "dtype": str(dtype).split(".")[-1],
                             "window": window, "shape": [bh, g, l, d],
                             "route": la.route(dtype, d),
                             "max_abs_err": err, "backward_max_abs_err": berr,
                             "ms": t[0], "plain_ms": t[1], "library_ms": t[2],
                             "library_backend": backend,
                             "library_kernels": names,
                             "bound_ms": max(t_ops, t_bytes),
                             "bound_by": ("operations" if t_ops >= t_bytes
                                          else "bytes")})
                print(f"  [{card}] kernel 6 at ({bh} / {bh // g}, {l}, {d}) "
                      f"{rows[-1]['dtype']} causal window {window}: route "
                      f"{rows[-1]['route']}, forward {t[0]:.4f} ms, plain "
                      f"{t[1]:.4f} ms, SDPA {t[2]:.4f} ms ({backend}), bound "
                      f"{rows[-1]['bound_ms']:.4f} ms "
                      f"({rows[-1]['bound_by']}); max |err| {err:.3e} "
                      f"forward, {berr:.3e} backward")
    return {"cases": rows}


# --- phase 13: MoE serving at full width -------------------------------------

# (arch, the layers kept, None for all): deepseek-v3-671b's 61 layers would
# be 1.34 TB of bf16; 5 layers (its 3 dense ones and 2 MoE ones, stacked)
# and the untied embed and head are 53.3 GB
MOE_SERVING = (("qwen2-moe-a2.7b", None), ("deepseek-v3-671b", 5))
# as published: (layers, d_model, heads, KV heads, vocab, dense d_ff,
# dense prefix, routed experts, top-k, expert width, shared experts)
MOE_WIDTHS = {"qwen2-moe-a2.7b": (24, 2048, 16, 16, 151936, 5632, 0, 60, 4,
                                  1408, 4),
              "deepseek-v3-671b": (61, 7168, 128, 128, 129280, 18432, 3, 256,
                                   8, 2048, 1)}
# deepseek-v3-671b's MLA as published: (q rank, kv rank, qk nope, qk rope,
# v head dim)
MLA_WIDTHS = (1536, 512, 128, 64, 128)
# kernel 6's Dv < D path beside its plain version, forward and backward:
# (heads, KV heads, L, D, Dv, dtype, causal); the MLA prefill shape and
# the smoke MLA's head dims on the FMA route in f32, and the tensor-core
# route at D 192 with GQA
DV_CASES = ((128, 128, 1024, 192, 128, torch.float32, True),
            (16, 4, 517, 192, 128, torch.bfloat16, True),
            (8, 8, 333, 12, 8, torch.float32, True),
            (8, 2, 300, 64, 40, torch.float32, False))


def drop_shares(moe, model, params, prompts, dev,
                max_len: int) -> tuple[list, list]:
    """The share of routed slots each prefill of ``prompts`` drops for
    capacity, over its MoE layers, and layer by layer: an expert's slots
    past ``capacity`` in a row are dropped, so a layer drops sum(max(count
    - C, 0)) of its S*k slots.  Read from the router's choices on a
    prefill run after the counted one (its launches are not counted)."""
    router, shares, by_layer = moe._router, [], []

    def recording(cfg, p, x):
        top, idx, aux = router(cfg, p, x)
        e = cfg.moe.n_routed
        counts = (idx.reshape(idx.shape[0], -1, 1)
                  == torch.arange(e, device=idx.device)).sum(1)   # (B, E)
        cap = moe.capacity(cfg, x.shape[1])
        seen.append((torch.clamp(counts - cap, min=0).sum(), idx.numel()))
        return top, idx, aux

    moe._router = recording
    try:
        for prompt in prompts:
            seen = []
            model.prefill(params, {"tokens": torch.tensor([prompt],
                                                          device=dev)},
                          max_len=max_len)
            shares.append(sum(int(d) for d, _ in seen)
                          / sum(n for _, n in seen))
            by_layer.append([int(d) / n for d, n in seen])
    finally:
        moe._router = router
    return shares, by_layer


def check_attention_dv(la, dev) -> float:
    """Kernel 6 with V narrower than q and k (``DV_CASES``) against its
    plain version on the card, through the wrapper (which pads V to D and
    slices the output back): the forward at 2e-5 in f32 and rtol 1e-2 /
    atol 1e-3 in bf16, the gradients within 1e-4 (f32) and 2e-2 (bf16) of
    max|plain|, each launch on its route, and dV of the caller's Dv
    columns.  Returns the max forward |err| in f32."""
    rng = np.random.default_rng(SEED + 11)
    err_f32 = 0.0
    for h, hkv, l, d, dv, dtype, causal in DV_CASES:
        g = h // hkv
        q, k, v = attn_inputs(rng, h, l, d, g, dtype, dev)
        v = v[..., :dv].contiguous()
        dout = torch.from_numpy(rng.standard_normal((h, l, dv)).astype(
            np.float32)).to(device=dev, dtype=dtype)
        kw = dict(causal=causal, kv_groups=g)
        la.reset_launches()
        got = attn_grads(lambda *t: la.local_flash_attention(*t, **kw),
                         q, k, v, dout)
        want = attn_grads(lambda *t: la.local_flash_attention_plain(
            *t, **kw), q, k, v, dout)
        torch.cuda.synchronize()
        path = la.route(dtype, d)
        check(la.local_flash_attention.launches_by_route[path] == 1
              and la.local_flash_attention.backward_launches_by_route[path]
              == 1, f"attention Dv {dv} < D {d} {dtype}: not launched on "
              f"{path}: {la.local_flash_attention.launches_by_route}")
        check(got[0].shape == (h, l, dv) and got[3].shape == v.shape,
              f"attention Dv {dv} < D {d}: out {tuple(got[0].shape)}, dv "
              f"{tuple(got[3].shape)}")
        f32 = dtype == torch.float32
        rtol, atol = (2e-5, 2e-5) if f32 else (1e-2, 1e-3)
        err = float((got[0].float() - want[0].float()).abs().max())
        check(max_violation(got[0].float(), want[0].float(), rtol, atol)
              <= 0.0, f"attention ({h}/{hkv}, {l}, {d}, Dv {dv}) {dtype}: "
              f"forward max |err| {err:.3e} outside rtol {rtol} / atol "
              f"{atol}")
        tol = 1e-4 if f32 else 2e-2
        for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            e = float((a.float() - b.float()).abs().max())
            top = float(b.float().abs().max())
            check(e <= tol * top, f"attention backward {name} ({h}/{hkv}, "
                  f"{l}, {d}, Dv {dv}) {dtype}: max |err| {e:.3e} > {tol} "
                  f"* {top:.3e}")
        if f32:
            err_f32 = max(err_f32, err)
    print(f"  kernel 6 at Dv < D: {len(DV_CASES)} cases ok (f32 on the FMA "
          "route at 2e-5 forward and 1e-4 * max|plain| backward, max "
          f"forward |err| {err_f32:.3e}; bf16 at D 192 / Dv 128 with GQA on "
          "the tensor-core route at 1e-2 / 1e-3 and 2e-2 * max|plain|); "
          "out and dV have the caller's Dv columns")
    return err_f32


def phase_moe_serving(rt, od, la, dev, card: str) -> dict:
    """qwen2-moe-a2.7b at full width and depth and deepseek-v3-671b at
    full width on 5 of its 61 layers, each serving phase 5's traffic,
    every prefill's attention on kernel 6's tensor-core route (MLA at D
    192 with V padded from 128); the capacity drops of each prefill; kernel
    6 at each model's prefill shape against its plain version."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import moe, param_counts

    out = {}
    for arch, layers in MOE_SERVING:
        cfg = configs.get_config(arch)
        m = cfg.moe
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.vocab_size, cfg.d_ff, cfg.dense_prefix, m.n_routed,
               m.top_k, m.d_expert, m.n_shared) == MOE_WIDTHS[arch],
              f"{arch} is not at its published width and depth")
        if cfg.mla is not None:
            a = cfg.mla
            check((a.q_lora_rank, a.kv_lora_rank, a.qk_nope_head_dim,
                   a.qk_rope_head_dim, a.v_head_dim) == MLA_WIDTHS,
                  f"{arch}'s MLA is not at its published width")
            d, dv = a.qk_head_dim, a.v_head_dim
        else:
            check(cfg.head_dim_ == 128 and cfg.attn_bias,
                  f"{arch}'s attention is not MHA at D 128 with bias")
            d = dv = cfg.head_dim_
        full_params = param_counts(cfg)[0]
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
            print(f"  {arch}: depth cut to {layers} of "
                  f"{MOE_WIDTHS[arch][0]} layers at full width "
                  f"({cfg.dense_prefix} dense, {layers - cfg.dense_prefix} "
                  f"MoE; {param_counts(cfg)[0]:,} of {full_params:,} "
                  "parameters)")
        check(la.route(cfg.activation_dtype, d) == "tensor_core",
              f"{arch}'s attention (D {d}) is not on kernel 6's tensor-core "
              "route")
        engine, reqs, run = serve_requests(rt, od, la, dev, cfg)
        ttft = run["ttft_ms"]
        caps = {n: moe.capacity(cfg, n) for n in PROMPT_LENS}
        run.update(
            full_params=full_params, depth_cut=layers,
            active_params=param_counts(cfg)[1],
            ttft_ms_median_by_round=[statistics.median(ttft[:SLOTS]),
                                     statistics.median(ttft[SLOTS:])],
            # decode reads every weight once a step (every expert: the
            # dispatch runs all E experts at C slots)
            decode_bytes_bound_ms=run["weight_gb"] * 1e9 / PEAK_BYTES_S
            * 1e3,
            capacity=caps)
        run["drop_share"], run["drop_share_by_layer"] = drop_shares(
            moe, engine.model.model, engine.params,
            [r.prompt for r in reqs], dev, MAX_LEN)
        del engine
        longest = PROMPT_LENS.index(max(PROMPT_LENS))
        print(f"  capacity per expert and row at {max(PROMPT_LENS)} tokens "
              f"{caps[max(PROMPT_LENS)]}; share of routed slots dropped "
              "per prefill (prompt length: share): " + ", ".join(
                  f"{n}: {sh:.4f}" for n, sh in zip(PROMPT_LENS,
                                                   run["drop_share"]))
              + f"; by MoE layer at {max(PROMPT_LENS)} tokens: "
              + ", ".join(f"{sh:.4f}" for sh in
                          run["drop_share_by_layer"][longest]))
        run["kernel6"] = attention_case(la, dev, cfg.n_heads, cfg.n_kv_heads,
                                        PREFILL_L, d, dv=dv, backward=True)
        print(f"  [{card}] {arch}: TTFT median {run['ttft_ms_median']:.1f} "
              f"ms (first round {run['ttft_ms_median_by_round'][0]:.1f}, "
              f"second {run['ttft_ms_median_by_round'][1]:.1f}), decode "
              f"{run['decode_tokens_per_s']:.1f} tok/s (median step "
              f"{run['decode_step_ms_median']:.3f} ms, bytes bound "
              f"{run['decode_bytes_bound_ms']:.3f} ms), peak memory "
              f"{run['peak_memory_gb']:.2f} GB, weights "
              f"{run['weight_gb']:.2f} GB")
        out[arch] = run
    out["dv_check_max_abs_err_f32"] = check_attention_dv(la, dev)
    return out


# --- phase 14: the encoder-decoder and vision families ---------------------

# as published: seamless-m4t-large-v2 (encoder layers, decoder layers,
# d_model, heads, KV heads, head dim, d_ff, vocab) and llava-next-34b
# (layers, d_model, heads, KV heads, head dim, d_ff, vocab, patches)
ENCDEC_ARCH, VISION_ARCH = "seamless-m4t-large-v2", "llava-next-34b"
ENCDEC_WIDTHS = (24, 24, 1024, 16, 16, 64, 8192, 256206)
VISION_WIDTHS = (60, 7168, 56, 8, 128, 20480, 64000, 576)
MM_LANES = 4             # requests in one batch, each on its own lane
MM_NEW = 32              # greedy tokens per request
# seamless: 1024 encoder frames and a 128-token prompt a request, max_len
# 512; llava: 576 patches and 512 text tokens (1088 positions), max_len 2048
ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_MAX_LEN = 1024, 128, 512
VISION_PROMPT, VISION_MAX_LEN = 512, 2048
# seamless's gradient step: batch 2 of 512 tokens and 1024 frames
ENCDEC_TRAIN = (2, 512, 1024)
MM_PREFILL_REPEATS = 3   # prefills after the counted one: TTFT's "others"


def mm_inputs(cfg, prompt_len: int, dev, seed: int) -> list[dict]:
    """MM_LANES requests of ``prompt_len`` tokens from a seeded numpy
    stream, each with its frames or patches (a normal draw at d_model),
    one batch dict per request (batch 1)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(MM_LANES):
        r = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (1, prompt_len))).to(dev)}
        if cfg.is_encdec:
            r["frames"] = torch.from_numpy(rng.standard_normal(
                (1, ENCDEC_FRAMES, cfg.d_model)).astype(np.float32)).to(dev)
        if cfg.frontend == "vision":
            r["patches"] = torch.from_numpy(rng.standard_normal(
                (1, cfg.frontend_tokens, cfg.d_model)).astype(
                    np.float32)).to(dev)
        reqs.append(r)
    return reqs


def stack_batch(reqs: list[dict]) -> dict:
    return {k: torch.cat([r[k] for r in reqs]) for k in reqs[0]}


def greedy(model, params, batch, new: int, max_len: int) -> tuple:
    """One prefill of ``batch`` and new - 1 greedy decode steps on all its
    lanes.  Returns (tokens per lane, prefill ms, decode step ms)."""
    t0 = time.perf_counter()
    cache, logits = model.prefill(params, batch, max_len=max_len)
    toks = [torch.argmax(logits, dim=-1)]
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step_ms = []
    for _ in range(new - 1):
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, cache, toks[-1][:, None])
        toks.append(torch.argmax(lg, dim=-1))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return torch.stack(toks, 1).tolist(), prefill_ms, step_ms


def identical_lanes(model, params, req: dict, new: int,
                    max_len: int) -> list[int]:
    """One request alone, repeated onto MM_LANES identical lanes of one
    prefill (every product at the batched run's shapes) and decoded
    greedily: the tokens that every lane must give."""
    same, _, _ = greedy(model, params,
                        {k: v.repeat(MM_LANES, *[1] * (v.ndim - 1))
                         for k, v in req.items()}, new, max_len)
    check(all(t == same[0] for t in same),
          f"identical lanes decoded {same}")
    return same[0]


def one_lane(model, params, req: dict, new: int, max_len: int) -> list[int]:
    """One request prefilled at 1 lane, its cache (``enc_out`` too)
    repeated onto MM_LANES lanes by ``lanes`` and decoded greedily
    (``offline_greedy``, which passes the frames or patches on)."""
    tokens = req["tokens"]
    return offline_greedy(
        model, params, tokens[0].tolist(), new, MM_LANES, tokens.device,
        max_len, extra={k: v for k, v in req.items() if k != "tokens"})


def encdec_one_lane_f32(dev, cfg, master, reqs: list[dict],
                        max_len: int) -> dict:
    """seamless's requests at float32 activations (its float32 masters as
    they are): each prefilled at 1 lane and repeated onto MM_LANES lanes
    by ``lanes`` must decode the tokens of the request on MM_LANES
    identical lanes of one prefill.  At bf16 activations a 1-row and a
    4-row prefill round differently and greedy decoding may part; at
    float32 the same comparison holds token for token."""
    import dataclasses
    from repro_torch.models import LM, compute_params
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = compute_params(cfg32, master)
    model = CheckedLM(LM(cfg32), dev)
    t0 = time.perf_counter()
    for i, req in enumerate(reqs):
        same = identical_lanes(model, params, req, MM_NEW, max_len)
        alone = one_lane(model, params, req, MM_NEW, max_len)
        check(alone == same, f"{cfg.name} request {i} at float32: prefilled "
              f"at 1 lane and repeated onto {MM_LANES} {alone} != on "
              f"{MM_LANES} identical lanes {same}")
    check(bool(model.finite), f"{cfg.name}: non-finite float32 logits")
    wall_s = time.perf_counter() - t0
    print(f"  {cfg.name} at float32 activations: each request prefilled at "
          f"1 lane and repeated onto {MM_LANES} (enc_out too) decodes the "
          f"tokens of the request on {MM_LANES} identical lanes "
          f"({len(reqs)} requests, {wall_s:.2f} s)")
    return {"requests": len(reqs), "new_tokens": MM_NEW, "wall_s": wall_s}


def mm_decode_bytes(cfg, params, cache) -> float:
    """Bytes a decode step must read at least: every decoder weight but
    the embedding table (only the new tokens' rows), the KV caches (the
    plain decode attention reads all of their slots), and per
    cross-attention layer the encoder memory once, its K and V written
    once and read once by the kernel."""
    from repro_torch.models.params import leaves
    weights = sum(t.numel() * t.element_size() for path, t in leaves(params)
                  if path[0] not in ("embed", "encoder", "frontend"))
    kv = sum(t.numel() * t.element_size() for path, t in leaves(
        {k: v for k, v in cache.items() if k in ("prefix", "stack", "tail")})
             if path[-1] in ("k", "v"))
    cross = 0
    if "enc_out" in cache:
        e = cache["enc_out"]
        kv_bytes = 2 * e.shape[0] * e.shape[1] * cfg.n_kv_heads \
            * cfg.head_dim_ * e.element_size()
        cross = cfg.n_layers * (e.numel() * e.element_size() + 2 * kv_bytes)
    return float(weights + kv + cross)


def serve_multimodal(la, dev, cfg, prompt_len: int, max_len: int,
                     card: str) -> tuple[dict, dict, object]:
    """``cfg`` at random weights from SEED answering MM_LANES requests in
    one batch (``prompt_len`` tokens each, with frames or patches), MM_NEW
    greedy tokens each, through ``LM.prefill`` / ``LM.decode_step`` with
    every logit checked for finiteness; kernel 6's counts set to 0 just
    before and read just after, in total, per route and per shape.  Then
    every request's tokens against the same request alone on identical
    lanes (``identical_lanes``) and prefilled at 1 lane (``one_lane``; for
    seamless at float32, ``encdec_one_lane_f32``), and MM_PREFILL_REPEATS
    more prefills for TTFT.  Returns (the run's numbers, the float32
    params, the model)."""
    from repro_torch.models import LM, compute_params, init_params
    from repro_torch.models import param_counts
    from repro_torch.models.params import leaves

    arch = cfg.name
    gc.collect()             # an earlier phase's models, cycles included
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    master = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    params = compute_params(cfg, master)
    if cfg.param_dtype == "bfloat16":
        master = None        # the compute tree is the same tensors
    model = CheckedLM(LM(cfg), dev)
    torch.cuda.synchronize()
    weight_gb = sum(t.numel() * t.element_size()
                    for _, t in leaves(params if master is None
                                       else master)) / 1e9
    compute_gb = sum(t.numel() * t.element_size()
                     for _, t in leaves(params)) / 1e9
    init_s = time.perf_counter() - t0
    print(f"  {arch}: {param_counts(cfg)[0]:,} parameters ({weight_gb:.2f} "
          f"GB of {cfg.param_dtype} weights, {compute_gb:.2f} GB as the "
          f"forward reads them), init {init_s:.2f} s, {held_gb:.2f} GB held "
          "before it")

    reqs = mm_inputs(cfg, prompt_len, dev, SEED + 14)
    batch = stack_batch(reqs)
    la.reset_launches()
    tokens, prefill_ms, step_ms = greedy(model, params, batch, MM_NEW,
                                         max_len)
    launches = {"local_flash_attention": la.local_flash_attention.launches,
                "local_flash_attention_by_route":
                    dict(la.local_flash_attention.launches_by_route),
                "local_flash_attention_by_shape":
                    dict(la.local_flash_attention.launches_by_shape)}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(bool(model.finite), f"{arch}: non-finite logits")
    check(all(len(t) == MM_NEW for t in tokens),
          f"{arch}: a request did not get {MM_NEW} tokens")

    # the count at each shape is held by ``held_at_path``
    check(launches["local_flash_attention_by_route"] ==
          {"tensor_core": launches["local_flash_attention"], "fma": 0},
          f"{arch}: kernel 6 launched {launches}, not all on the "
          "tensor-core route")
    print(f"  {arch}: {MM_LANES} requests in one batch, {MM_NEW} tokens "
          f"each; kernel 6 launches {launches}; peak memory {peak_gb:.2f} GB")

    # seamless's 1-lane comparison runs at float32 (encdec_one_lane_f32)
    for i, req in enumerate(reqs):
        same = identical_lanes(model, params, req, MM_NEW, max_len)
        check(tokens[i] == same, f"{arch} request {i}: batched tokens "
              f"{tokens[i]} != the request alone on {MM_LANES} lanes {same}")
        if not cfg.is_encdec:
            alone = one_lane(model, params, req, MM_NEW, max_len)
            check(tokens[i] == alone, f"{arch} request {i}: batched tokens "
                  f"{tokens[i]} != the request prefilled at 1 lane and "
                  f"repeated onto {MM_LANES} {alone}")
    check(bool(model.finite), f"{arch}: non-finite logits offline")
    print(f"  {arch}: every request's tokens == the request prefilled alone "
          f"on {MM_LANES} identical lanes + greedy decode"
          + ("" if cfg.is_encdec else f", and == the request prefilled at 1 "
             f"lane and repeated onto {MM_LANES}"))
    one_lane_f32 = (encdec_one_lane_f32(dev, cfg, master, reqs, max_len)
                    if cfg.is_encdec else None)

    others = []
    for _ in range(MM_PREFILL_REPEATS):
        t0 = time.perf_counter()
        cache, _ = model.prefill(params, batch, max_len=max_len)
        torch.cuda.synchronize()
        others.append((time.perf_counter() - t0) * 1e3)
    step = statistics.median(step_ms)
    nbytes = mm_decode_bytes(cfg, params, cache)
    del cache
    out = {"arch": arch, "n_layers": cfg.n_layers,
           "encoder_layers": cfg.encoder_layers, "lanes": MM_LANES,
           "prompt_len": prompt_len, "positions": batch["tokens"].shape[1]
           + cfg.frontend_tokens, "max_len": max_len, "new_tokens": MM_NEW,
           "launches": launches,
           "ttft_ms_first": prefill_ms, "ttft_ms_others": others,
           "ttft_ms_median_others": statistics.median(others),
           "decode_step_ms": step_ms, "decode_step_ms_median": step,
           "decode_tokens_per_s": MM_LANES * 1e3 / step,
           "decode_bytes": nbytes,
           "decode_bytes_bound_ms": nbytes / PEAK_BYTES_S * 1e3,
           "weight_gb": weight_gb, "compute_weight_gb": compute_gb,
           "peak_memory_gb": peak_gb, "held_before_gb": held_gb,
           "init_s": init_s, "one_lane_f32": one_lane_f32, "card": card}
    print(f"  [{card}] {arch}: TTFT (prefill wall of {MM_LANES} requests) "
          f"first {prefill_ms:.1f} ms, median of {MM_PREFILL_REPEATS} more "
          f"{out['ttft_ms_median_others']:.1f} ms; decode "
          f"{out['decode_tokens_per_s']:.1f} tok/s (median step "
          f"{step:.3f} ms over {len(step_ms)} steps, bytes bound "
          f"{out['decode_bytes_bound_ms']:.3f} ms for {nbytes / 1e9:.3f} "
          f"GB); weights {weight_gb:.2f} GB, peak {peak_gb:.2f} GB")
    return out, master, model.model


def encdec_grad_step(la, dev, model, master) -> dict:
    """seamless's ``LM.loss`` + ``.backward()`` at ENCDEC_TRAIN (float32
    masters, every encoder and decoder block rematerialized): the loss and
    every gradient finite, kernel 6's backward launched once per encoder
    layer, decoder self-attention and cross-attention, all on the
    tensor-core route."""
    from repro_torch.models.params import leaves, map_tree
    b, s, f = ENCDEC_TRAIN
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 15)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1))).to(
        dev)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "frames": torch.from_numpy(rng.standard_normal(
                 (b, f, cfg.d_model)).astype(np.float32)).to(dev)}
    params = map_tree(lambda t: t.requires_grad_(True), master)
    torch.cuda.reset_peak_memory_stats(dev)
    wall_ms = []
    for _ in range(2):       # the first step's wall, then a second one
        for _, p in leaves(params):
            p.grad = None
        la.reset_launches()
        t0 = time.perf_counter()
        loss, metrics = model.loss(params, batch)
        loss.backward()
        torch.cuda.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    fwd = dict(la.local_flash_attention.launches_by_route)
    bwd = dict(la.local_flash_attention.backward_launches_by_route)
    fwd_by_shape = dict(la.local_flash_attention.launches_by_shape)
    bwd_by_shape = dict(la.local_flash_attention.backward_launches_by_shape)
    n = cfg.encoder_layers + 2 * cfg.n_layers
    finite = all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                 for _, p in leaves(params))
    check(bool(torch.isfinite(loss)) and finite,
          f"{cfg.name}: non-finite loss {float(loss.detach())} or gradient")
    # every block is rematerialized: its forward runs twice
    check(bwd == {"tensor_core": n, "fma": 0}
          and fwd == {"tensor_core": 2 * n, "fma": 0},
          f"{cfg.name} gradient step: kernel 6 forward {fwd}, backward "
          f"{bwd}, want {2 * n} and {n} on the tensor-core route")
    check(fwd_by_shape == {k: 2 * c for k, c in bwd_by_shape.items()},
          f"{cfg.name} gradient step: kernel 6 forward at {fwd_by_shape}, "
          f"backward at {bwd_by_shape}: each shape's forward not twice its "
          "backward")
    out = {"batch": b, "tokens": s, "frames": f,
           "loss": float(loss.detach()),
           "n_tokens": float(metrics["n_tokens"]), "wall_ms": wall_ms,
           "forward_launches": fwd, "backward_launches": bwd,
           "forward_by_shape": fwd_by_shape,
           "backward_by_shape": bwd_by_shape,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    for _, p in leaves(params):
        p.grad = None
        p.requires_grad_(False)
    print(f"  {cfg.name} loss + backward at batch {b} x {s} tokens, {f} "
          f"frames: loss {out['loss']:.4f}, every gradient finite, "
          f"{wall_ms[0]:.1f} ms (first step), {wall_ms[1]:.1f} ms (second), "
          f"peak {out['peak_memory_gb']:.2f} GB; kernel 6 forward {fwd}, "
          f"backward {bwd} (each step)")
    return out


def held_at_path(la, by_shape: dict, cases: dict, what: str) -> dict:
    """``cases`` maps a row name to (kernel 6 held to its plain version at
    one shape, ``attention_case``'s row; the launches the path should make
    there).  Each row gets ``launches``, its shape's count in ``by_shape``,
    which the path's run filled; the run must have launched kernel 6 at
    these shapes and no other, each as many times as ``cases`` says."""
    rows = {}
    for name, (row, want) in cases.items():
        h, hkv, l, d = row["shape"]
        key = la.shape_key(h, hkv, l, row["lk"], d, row["causal"],
                           row["window"])
        rows[name] = {**row, "shape_key": key,
                      "launches": by_shape.get(key, 0),
                      "launches_want": want}
    want = {r["shape_key"]: r["launches_want"] for r in rows.values()}
    check(by_shape == want, f"{what}: kernel 6 launched at {by_shape}, "
          f"want {want}")
    return rows


def phase_multimodal(la, dev, card: str) -> dict:
    """seamless-m4t-large-v2 and llava-next-34b at full width and depth,
    one after the other, each answering MM_LANES requests in one batch;
    seamless's gradient step; kernel 6 at every shape each run launched
    it, beside its plain version, SDPA and its bound (``attention_case``),
    with the run's launches there."""
    from repro_torch import configs

    out = {}
    cfg = configs.get_config(ENCDEC_ARCH)
    check((cfg.encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
           cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff, cfg.vocab_size)
          == ENCDEC_WIDTHS, f"{ENCDEC_ARCH} is not at its published width "
          "and depth")
    check(la.route(cfg.activation_dtype, cfg.head_dim_) == "tensor_core",
          f"{ENCDEC_ARCH}'s attention is not on kernel 6's tensor cores")
    run, master, model = serve_multimodal(la, dev, cfg, ENCDEC_PROMPT,
                                          ENCDEC_MAX_LEN, card)
    run["grad_step"] = encdec_grad_step(la, dev, model, master)
    del master, model
    # kernel 6 at the batch's (lanes x heads) rows, as ``attention_case``'s
    # one sequence of that many heads: a prefill's encoder, decoder
    # self-attention and cross-attention, every decode step's
    # cross-attention at Lq 1; the gradient step's three backwards
    h, d, n = cfg.n_heads, cfg.head_dim_, cfg.n_layers
    bh = MM_LANES * h
    b, s, f = ENCDEC_TRAIN
    run["kernel6"] = held_at_path(
        la, run["launches"]["local_flash_attention_by_shape"], {
            "local_flash_attention_encoder_d64": (attention_case(
                la, dev, bh, bh, ENCDEC_FRAMES, d, causal=False),
                cfg.encoder_layers),
            "local_flash_attention_decoder_self_d64": (attention_case(
                la, dev, bh, bh, ENCDEC_PROMPT, d), n),
            "local_flash_attention_cross_prefill_d64": (attention_case(
                la, dev, bh, bh, ENCDEC_PROMPT, d, lk=ENCDEC_FRAMES,
                causal=False), n),
            "local_flash_attention_cross_decode_lq1_d64": (attention_case(
                la, dev, bh, bh, 1, d, lk=ENCDEC_FRAMES, causal=False),
                n * (MM_NEW - 1))},
        f"{ENCDEC_ARCH} serving")
    run["kernel6_backward"] = held_at_path(
        la, run["grad_step"]["backward_by_shape"], {
            "local_flash_attention_encoder_d64_backward": (attention_case(
                la, dev, b * h, b * h, f, d, causal=False, backward=True),
                cfg.encoder_layers),
            "local_flash_attention_decoder_self_d64_backward": (
                attention_case(la, dev, b * h, b * h, s, d, backward=True),
                n),
            "local_flash_attention_cross_d64_backward": (attention_case(
                la, dev, b * h, b * h, s, d, lk=f, causal=False,
                backward=True), n)},
        f"{ENCDEC_ARCH} gradient step")
    out[ENCDEC_ARCH] = run

    cfg = configs.get_config(VISION_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
           cfg.head_dim_, cfg.d_ff, cfg.vocab_size, cfg.frontend_tokens)
          == VISION_WIDTHS, f"{VISION_ARCH} is not at its published width "
          "and depth")
    check(la.route(cfg.activation_dtype, cfg.head_dim_) == "tensor_core",
          f"{VISION_ARCH}'s attention is not on kernel 6's tensor cores")
    # 68.9 GB of weights, a 2.0 GB cache and the prefill's activations on
    # a 79.2 GiB card, all 60 layers: an out-of-memory error fails the phase
    run, _, model = serve_multimodal(la, dev, cfg, VISION_PROMPT,
                                     VISION_MAX_LEN, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    run["kernel6"] = held_at_path(
        la, run["launches"]["local_flash_attention_by_shape"], {
            "local_flash_attention_d128_gqa7": (attention_case(
                la, dev, MM_LANES * cfg.n_heads, MM_LANES * cfg.n_kv_heads,
                VISION_PROMPT + cfg.frontend_tokens, cfg.head_dim_),
                cfg.n_layers)},
        f"{VISION_ARCH} serving")
    out[VISION_ARCH] = run
    return out


# --- phase 15: the mesh and the dry run ---------------------------------------


def timed_step(step_fn, params, state, batch
               ) -> tuple[float, float, dict, float]:
    """(loss, wall s, the new params, gradient norm) of one step, its loss
    read on the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new_params, _, metrics = step_fn(params, state, batch, 0)
    loss = float(metrics["loss"])
    torch.cuda.synchronize()
    return (loss, time.perf_counter() - t0, new_params,
            float(metrics["grad_norm"]))


def update_error(got: dict, want: dict) -> float:
    """The largest difference of two params trees, each leaf's relative to
    its largest entry in ``want``; ``got`` may hold DTensors (on a (1, 1)
    mesh their local shard is the whole) and ``want`` lie on the host."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.params import leaves
    err = 0.0
    for (_, a), (_, b) in zip(leaves(got), leaves(want)):
        a = a.to_local() if isinstance(a, DTensor) else a
        b = b.to(a.device)
        err = max(err, float((a - b).abs().max()
                             / b.abs().max().clamp(min=1e-30)))
    return err


def phase_mesh(la, dev, card: str, training: dict) -> dict:
    """stablelm-1.6b at full width and depth: one AdamW step unmeshed and
    the same step on a (1, 1) ``(data, model)`` CUDA mesh, on the same
    params (random, from the seed) and phase 6's Markov batch; each run
    twice, the second timed.  The meshed run's params, AdamW state and
    batch are DTensors laid out by the spec trees."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.data import MarkovTask
    from repro_torch.distributed.compat import enter_mesh
    from repro_torch.distributed.sharding import (current_axis_names,
                                                  distribute_tree)
    from repro_torch.distributed.specs import batch_pspecs, opt_pspecs
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.distributed import sharding
    from repro_torch.models import LM, init_params, layers
    from repro_torch.models.params import leaves, map_tree, param_pspecs
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    cfg = configs.get_config(ARCH)
    check(cfg.n_layers == 24 and cfg.d_model == 2048,
          f"{ARCH} is not at full width and depth")
    model = LM(cfg)
    opt = adamw(3e-3)
    step_fn = make_train_step(model, opt)
    batch = MarkovTask(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                       global_batch=TRAIN_BATCH, seed=SEED).batch(0, dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    state = opt.init(params)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    plain, plain_new = [], None
    for _ in range(2):
        loss, wall, new, grad_norm = timed_step(step_fn, params, state,
                                                batch)
        plain.append((loss, wall, grad_norm))
        if plain_new is None:     # the update, kept on the host
            plain_new = map_tree(lambda t: t.cpu(), new)
        del new
    plain_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh(MESH_SHAPE, ("data", "model"))
        check(mesh.device_type == "cuda" and mesh.size() == 1,
              f"the test mesh is {mesh}")
        enter_mesh(mesh)
        pps = param_pspecs(cfg, fsdp_size=0, tp_size=MESH_SHAPE[1])
        dparams = distribute_tree(params, pps, mesh)
        dstate = distribute_tree(state, opt_pspecs(state, pps), mesh)
        dbatch = distribute_tree(batch, batch_pspecs(
            batch, mesh.mesh_dim_names, dp_total=MESH_SHAPE[0]), mesh)
        del params, state
        axes = []
        on_shards = ops._on_shards

        def spy(q, k, v, **kw):
            axes.append(current_axis_names())
            check(all(isinstance(t, DTensor) for t in (q, k, v)),
                  "kernel 6's DTensor path got a plain tensor")
            return on_shards(q, k, v, **kw)

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        la.reset_launches()
        entered = (layers._VocabParallelLSE.calls, sharding._PadHeads.calls)
        ops._on_shards = spy
        try:
            loss, first_s, new, grad_norm = timed_step(
                step_fn, dparams, dstate, dbatch)
        finally:
            ops._on_shards = on_shards
        # on a (1, 1) mesh nothing is split: the cross-entropy keeps
        # torch.logsumexp and the heads their reshape
        entered = (layers._VocabParallelLSE.calls - entered[0],
                   sharding._PadHeads.calls - entered[1])
        f = la.local_flash_attention
        launches = {"forward": f.launches,
                    "backward": f.backward_launches,
                    "forward_by_route": dict(f.launches_by_route),
                    "backward_by_route": dict(f.backward_launches_by_route),
                    "forward_by_shape": dict(f.launches_by_shape),
                    "backward_by_shape": dict(f.backward_launches_by_shape)}
        kept = all(isinstance(b, DTensor)
                   and tuple(a.placements) == tuple(b.placements)
                   for (_, a), (_, b) in zip(leaves(dparams), leaves(new)))
        update_err = update_error(new, plain_new)
        del new, plain_new
        again, step_s, _, _ = timed_step(step_fn, dparams, dstate, dbatch)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    finally:
        enter_mesh(None)
        dist.destroy_process_group()
    del dparams, dstate, dbatch
    gc.collect()
    torch.cuda.empty_cache()

    diff = abs(loss - plain[0][0])
    norm_err = abs(grad_norm - plain[0][2]) / plain[0][2]
    print(f"  {ARCH} on a {MESH_SHAPE} (data, model) mesh, one AdamW step "
          f"of {TRAIN_BATCH} x {TRAIN_SEQ} tokens: loss {loss:.6f}, "
          f"unmeshed {plain[0][0]:.6f}, |difference| {diff:.3e} "
          f"(bound {MESH_TOL}); gradient norm {grad_norm:.6f}, unmeshed "
          f"{plain[0][2]:.6f}, relative difference {norm_err:.3e} (bound "
          f"{MESH_TOL}); updated params' largest difference {update_err:.3e}"
          f" of a leaf's largest (bound {MESH_TOL}); a repeat of the meshed "
          f"step {again:.6f}; placements kept: {kept}; the vocab-parallel "
          f"log-sum-exp entered {entered[0]} times, the padded head split "
          f"{entered[1]} times")
    print(f"  kernel 6 in the meshed step: {launches['forward']} forward "
          f"{launches['forward_by_route']}, {launches['backward']} backward "
          f"{launches['backward_by_route']}, at {launches['forward_by_shape']}"
          f"; the DTensor path took {len(axes)} calls under mesh axes "
          f"{sorted(set(axes))}")
    print(f"  [{card}] meshed step wall {step_s:.4f} s (first "
          f"{first_s:.4f} s), peak memory {peak_gb:.2f} GB; unmeshed step "
          f"on the same params and batch {plain[1][1]:.4f} s (first "
          f"{plain[0][1]:.4f} s), peak {plain_peak_gb:.2f} GB "
          f"({held_gb:.2f} GB held at the phase's start); phase 6's "
          f"median step {training['step_wall_s_median']:.4f} s, peak "
          f"{training['peak_memory_gb']:.2f} GB")
    check(np.isfinite(loss) and diff <= MESH_TOL,
          f"meshed loss {loss} against unmeshed {plain[0][0]}")
    check(entered == (0, 0), f"on the {MESH_SHAPE} mesh the vocab-parallel "
          f"log-sum-exp and the padded head split ran {entered} times")
    check(norm_err <= MESH_TOL, f"meshed gradient norm {grad_norm} against "
          f"unmeshed {plain[0][2]}")
    check(update_err <= MESH_TOL, f"the meshed step's updated params differ "
          f"from the unmeshed step's by {update_err} of a leaf's largest")
    check(kept, "a parameter lost its placements in the meshed step")
    n = cfg.n_layers
    check(launches["forward_by_route"] == {"tensor_core": 2 * n, "fma": 0}
          and launches["backward_by_route"] == {"tensor_core": n, "fma": 0},
          f"kernel 6 in the meshed step: {launches} (want {2 * n} forward "
          f"and {n} backward a step, all on the tensor-core route)")
    check(len(axes) == 2 * n and set(axes) == {("data", "model")},
          f"the DTensor path of kernel 6 ran {len(axes)} times under "
          f"{set(axes)}")
    h = TRAIN_BATCH * cfg.n_heads
    held = attention_case(la, dev, h, h, TRAIN_SEQ, cfg.head_dim_,
                          backward=True)
    rows = held_at_path(la, launches["forward_by_shape"],
                        {"local_flash_attention": (held, 2 * n)},
                        "meshed step forward")
    held_at_path(la, launches["backward_by_shape"],
                 {"local_flash_attention_backward": (held, n)},
                 "meshed step backward")
    return {"arch": ARCH, "mesh": list(MESH_SHAPE), "loss": loss,
            "loss_unmeshed": plain[0][0], "loss_difference": diff,
            "grad_norm": grad_norm, "grad_norm_unmeshed": plain[0][2],
            "grad_norm_relative_difference": norm_err,
            "update_error": update_err,
            "loss_repeat": again, "placements_kept": kept,
            "vocab_parallel_lse_calls": entered[0],
            "padded_head_calls": entered[1],
            "step_wall_s": step_s, "first_step_wall_s": first_s,
            "unmeshed_step_wall_s": plain[1][1],
            "unmeshed_first_step_wall_s": plain[0][1],
            "peak_memory_gb": peak_gb,
            "unmeshed_peak_memory_gb": plain_peak_gb,
            "held_before_gb": held_gb, "launches": launches,
            "kernel6": rows["local_flash_attention"]}


def padded_attention_work(cfg, sh, devices: int
                          ) -> tuple[float, float, int]:
    """Kernel 6's charged work in a training step of ``cfg`` at shape
    ``sh`` (the count's own rules, ``_attention_work`` for the forward
    and its recompute and ``_attention_backward_work`` for the backward
    in each layer, plus the outputs each launch writes), globally, and a
    device's share when its ``model`` rank (of 16) runs hl padded heads
    (``sharding.head_pad``) of its rows of the batch.  Returns (global,
    a device's, hl)."""
    from repro_torch.distributed.sharding import head_pad
    from repro_torch.kernels.local_attention import (
        _attention_backward_work, _attention_work)
    h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    meta = lambda heads: torch.empty(
        (sh.global_batch * heads, sh.seq_len, d), device="meta",
        dtype=cfg.activation_dtype)
    q, kv = meta(h), meta(hk)
    fwd = sum(_attention_work(q, kv, kv).values()) + q.numel()
    bwd = sum(_attention_backward_work(q, kv, kv).values()) \
        + q.numel() + 2 * kv.numel()
    work = cfg.n_layers * (2 * fwd + bwd)
    hl = len(head_pad(h, hk, 16)) // 16
    return work, work * hl / h / (devices // 16), hl


def phase_dryrun(card: str) -> dict:
    """The dry run of ``DRYRUN_CELLS`` in its own process (it builds its
    meshes over a fake process group of 512 ranks): each record's global
    counts, its partitioned pass (FLOPs, bytes and collective bytes a
    device) and its roofline row at the H100's constants; one
    cross-entropy chunk's collectives beside their shape arithmetic (no
    vocab gather, the log-sum-exp's two all-reduces); the x split of the
    cells whose heads run padded against the padding arithmetic
    (``padded_attention_work``); every record's microbatches all counted
    and its Shard-to-Shard redistributes counted as all-to-all."""
    import os
    import shutil
    from repro_torch import configs
    from repro_torch.casestudy.roofline import roofline_row
    from repro_torch.core.profiler import COLLECTIVE_KINDS
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    cells = [a for cell in DRYRUN_CELLS for a in ("--cell", *cell)]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *cells,
         "--outdir", str(DRYRUN_DIR)], env=env, capture_output=True,
        text=True, timeout=DRYRUN_TIMEOUT_S, cwd=root)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"the dry run failed: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    out = {"wall_s": wall}
    for arch, shape, meshes in DRYRUN_CELLS:
        for mesh in (("single", "multi") if meshes == "both" else (meshes,)):
            rec = json.loads((DRYRUN_DIR / f"{arch}__{shape}__{mesh}.json")
                             .read_text())
            mem = rec["analytic_memory_per_device"]
            coll = rec["collective_bytes"]
            check(rec["source"] == "meta" and rec["jaxpr_flops_global"] > 0
                  and rec["argument_bytes_per_device"] > 0
                  and 0 < rec["flops"] < rec["jaxpr_flops_global"]
                  and rec["bytes_accessed"] > 0
                  and set(coll) <= set(COLLECTIVE_KINDS)
                  and rec["collective_bytes_total"] == sum(coll.values()) > 0,
                  f"dry-run record {rec['cell']}")
            # every configured microbatch counted (rows the data devices
            # do not divide run padded), and each Shard-to-Shard
            # redistribute as the all-to-all the card sends: no collective
            # counted inside DTensor's CPU route (an all-gather)
            s2s = rec["shard_to_shard"]
            check(rec["accum_counted"] == rec["accum_steps"]
                  and s2s["fallback_collectives"] == 0
                  and s2s["bytes"] <= coll.get("all-to-all", 0.0),
                  f"{rec['cell']}: {rec['accum_counted']} of "
                  f"{rec['accum_steps']} microbatches counted, "
                  f"Shard-to-Shard {s2s}, all-to-all "
                  f"{coll.get('all-to-all', 0.0)}")
            row = roofline_row(rec)
            keep = {k: rec[k] for k in (
                "devices", "argument_bytes_per_device",
                "output_bytes_per_device", "jaxpr_flops_global",
                "jaxpr_flops_by_category", "jaxpr_traffic_bytes_global",
                "flops", "flops_by_category_per_device", "bytes_accessed",
                "bytes_min", "partition", "accum_steps", "accum_counted",
                "collective_bytes", "collective_bytes_total",
                "ce_chunk_collective_bytes", "shard_to_shard", "count_s",
                "partition_s")}
            keep.update(analytic_memory_per_device=mem, roofline=row)
            print(f"  dry run {rec['cell']} ({rec['devices']} devices): "
                  f"argument bytes per device "
                  f"{rec['argument_bytes_per_device']:,}, analytic total "
                  f"{mem['total'] / 2**30:.3f} GiB a device (fits 16 GiB "
                  f"{mem['fits_16gb']}, fits an H100's 80 GB "
                  f"{mem['fits_h100_80gb']}), global FLOPs "
                  f"{rec['jaxpr_flops_global']:.4e}; a device: FLOPs "
                  f"{rec['flops']:.4e}, bytes it must move "
                  f"{rec['bytes_min']:.4e} (eager traffic "
                  f"{rec['bytes_accessed']:.4e}), "
                  "collective bytes " + ", ".join(
                      f"{k} {v:.4e}" for k, v in sorted(coll.items()))
                  + f" (count {rec['count_s']} s, partitioned "
                  f"{rec['partition_s']} s, counted as {rec['partition']}, "
                  f"{rec['accum_counted']} of {rec['accum_steps']} "
                  f"microbatches; {s2s['calls']} Shard-to-Shard "
                  f"redistributes counted as {s2s['bytes']:,.0f} B of "
                  f"all-to-all)")
            print(f"    roofline at the H100's constants: compute "
                  f"{row['compute_s']:.4e} s, memory {row['memory_s']:.4e} s, "
                  f"collective {row['collective_s']:.4e} s (eager traffic "
                  f"{row['traffic_s']:.4e} s, not a bound), dominant "
                  f"{row['dominant']}, bound {row['step_lower_bound_s']:.4e} "
                  f"s, useful {row['useful_ratio']:.3f}")
            cfg = configs.get_config(arch)
            sh = configs.SHAPES[shape]
            if rec["ce_chunk_collective_bytes"] is not None \
                    and arch == "stablelm-1.6b":
                ce = rec["ce_chunk_collective_bytes"]
                b_local = sh.global_batch // (rec["devices"] // 16)
                sc = sh.seq_len // cfg.logit_chunks
                arith = 2 * b_local * sc * 4
                # the label pick's partial sum, one value a row, is
                # reduced inside the chunk by torch 2.11's DTensor and
                # after it by 2.13's
                pick = b_local * sc * 4
                keep["ce_all_reduce_shape_arithmetic"] = arith
                print(f"    one CE chunk (vocab split over model): counted "
                      f"all-gather {ce.get('all-gather', 0.0):,.0f} B, "
                      f"all-reduce {ce.get('all-reduce', 0.0):,.0f} B a "
                      f"device; shape arithmetic: no gather, the row max "
                      f"and sum 2 x {b_local} x {sc} x 4 = {arith:,} B, "
                      f"and the label pick's sum {pick:,} B where DTensor "
                      f"reduces it in the chunk")
                check(ce.get("all-gather", 0.0) == 0.0
                      and ce.get("all-reduce", 0.0) in (arith, arith + pick),
                      f"{rec['cell']}: the CE chunk counted {ce} against "
                      f"no all-gather and {arith} B (+ {pick} B) of "
                      f"all-reduce")
            if cfg.n_heads % 16 and sh.kind == "train":
                even = rec["jaxpr_flops_global"] / rec["devices"]
                x = rec["flops"] / even
                work, mine, hl = padded_attention_work(cfg, sh,
                                                       rec["devices"])
                rest = (rec["flops"] - mine) / (
                    (rec["jaxpr_flops_global"] - work) / rec["devices"])
                whole = (rec["flops"] - mine + mine * cfg.n_heads / hl) \
                    / even
                keep.update(x_split=x, x_split_without_attention=rest,
                            attention_flops_global=work,
                            attention_flops_per_device=mine)
                print(f"    x split {x:.4f}: kernel 6's charged work "
                      f"{work:.4e} FLOPs in all, {mine:.4e} a device at "
                      f"the padding arithmetic ({hl} of {cfg.n_heads} heads "
                      f"a model rank, padded {16 * hl} = 16 x {hl}; "
                      f"{mine / even:.4f} x the step's even share), the rest "
                      f"{rest:.4f} (band {X_SPLIT_BAND}); with every head "
                      f"on every model rank the x split would be "
                      f"{whole:.4f}")
                check(X_SPLIT_BAND[0] <= rest <= X_SPLIT_BAND[1],
                      f"{rec['cell']}: x split {x}, {rest} without kernel "
                      f"6's work at the padding arithmetic, out of the "
                      f"band {X_SPLIT_BAND}")
            out[rec["cell"]] = keep
    print(f"  [{card}] dry-run subprocess wall {wall:.2f} s")
    return out


# --- phase 16: the mesh's serving and the roofline against the card ---------

MESH_MOE_ARCH = "qwen2-moe-a2.7b"
MESH_MOE_NEW = 16        # greedy decode steps after the prefill


def greedy_run(model, params, prompt, new: int, max_len: int) -> dict:
    """A prefill of ``prompt`` (1, L) and ``new`` greedy decode steps at
    batch 1: each step's logits (on the host), the tokens, the cache, the
    prefill's wall and each decode step's wall.  DTensor logits are
    gathered whole (on one device, their local shard)."""
    from torch.distributed.tensor import DTensor
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, lg = model.prefill(params, {"tokens": prompt}, max_len=max_len)
    lg = whole(lg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    logits, toks, steps = [lg.float().cpu()], [], []
    for _ in range(new):
        nxt = torch.argmax(lg, dim=-1, keepdim=True)
        toks.append(int(nxt))
        t0 = time.perf_counter()
        lg, cache = model.decode_step(params, cache, nxt)
        lg = whole(lg)
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
        logits.append(lg.float().cpu())
    return {"logits": logits, "tokens": toks, "cache": cache,
            "prefill_s": prefill_s, "decode_s": steps}


def phase_mesh_serving(la, dev, card: str, kernel6: dict) -> dict:
    """qwen2-moe-a2.7b at full width and depth: a prefill of phase 13's
    first request, drawn at kernel 6's timed length (PREFILL_L tokens),
    and MESH_MOE_NEW greedy decode steps, unmeshed and on a (1, 1) ``(data,
    model)`` CUDA mesh of one NCCL rank with params, tokens and cache
    DTensors.  The meshed run's logits, cache and tokens against the
    unmeshed run's (MESH_TOL), kernel 6's launches through the DTensor
    path on the tensor-core route at (16 / 16, PREFILL_L, 128), both
    runs' walls."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch import configs
    from repro_torch.distributed.compat import enter_mesh
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.distributed.specs import batch_pspecs
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import LM, compute_params, init_params
    from repro_torch.models.params import leaves, param_pspecs

    cfg = configs.get_config(MESH_MOE_ARCH)
    check(cfg.n_layers == MOE_WIDTHS[MESH_MOE_ARCH][0]
          and cfg.d_model == MOE_WIDTHS[MESH_MOE_ARCH][1],
          f"{MESH_MOE_ARCH} is not at full width and depth")
    gc.collect()
    torch.cuda.empty_cache()
    params = compute_params(cfg, init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev))
    rng = np.random.default_rng(SEED + 4)     # phase 13's request stream
    prompt = torch.tensor([rng.integers(0, cfg.vocab_size, PREFILL_L)
                           .tolist()], device=dev)
    max_len = PREFILL_L + MESH_MOE_NEW + 1
    model = LM(cfg)
    plain = greedy_run(model, params, prompt, MESH_MOE_NEW, max_len)

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_test_mesh(MESH_SHAPE, ("data", "model"))
        enter_mesh(mesh)
        dparams = distribute_tree(params, param_pspecs(
            cfg, fsdp_size=0, tp_size=MESH_SHAPE[1]), mesh)
        dprompt = distribute_tree({"tokens": prompt}, batch_pspecs(
            {"tokens": prompt}, mesh.mesh_dim_names,
            dp_total=MESH_SHAPE[0]), mesh)["tokens"]
        shards = []
        on_shards = ops._on_shards

        def spy(q, k, v, **kw):
            shards.append(all(isinstance(t, DTensor) for t in (q, k, v)))
            return on_shards(q, k, v, **kw)

        la.reset_launches()
        ops._on_shards = spy
        try:
            meshed = greedy_run(model, dparams, dprompt, MESH_MOE_NEW,
                                max_len)
        finally:
            ops._on_shards = on_shards
        f = la.local_flash_attention
        launches = {"forward": f.launches,
                    "forward_by_route": dict(f.launches_by_route),
                    "forward_by_shape": dict(f.launches_by_shape)}
        cache_err = 0.0
        for (_, a), (_, b) in zip(leaves(meshed["cache"]),
                                  leaves(plain["cache"])):
            a = a.to_local() if isinstance(a, DTensor) else a
            cache_err = max(cache_err,
                            float((a.float() - b.float()).abs().max()))
        dtensor_leaves = sum(isinstance(t, DTensor)
                             for _, t in leaves(meshed["cache"]))
    finally:
        enter_mesh(None)
        dist.destroy_process_group()
    del params, dparams, plain["cache"], meshed["cache"]
    gc.collect()
    torch.cuda.empty_cache()

    logit_err = max(float((a - b).abs().max())
                    for a, b in zip(meshed["logits"], plain["logits"]))
    n = cfg.n_layers
    walls = {tag: {"prefill_s": run["prefill_s"],
                   "decode_step_s_median": statistics.median(run["decode_s"]),
                   "decode_step_s": run["decode_s"]}
             for tag, run in (("unmeshed", plain), ("meshed", meshed))}
    print(f"  {MESH_MOE_ARCH} on a {MESH_SHAPE} (data, model) mesh: a "
          f"prefill of {PREFILL_L} tokens and {MESH_MOE_NEW} greedy decode "
          f"steps; logits' largest difference from the unmeshed run "
          f"{logit_err:.3e}, cache's {cache_err:.3e} (bound {MESH_TOL}); "
          f"tokens equal: {meshed['tokens'] == plain['tokens']} "
          f"({meshed['tokens'][:8]}...); {dtensor_leaves} cache leaves "
          "DTensors")
    print(f"  kernel 6 in the meshed prefill: {launches['forward']} "
          f"{launches['forward_by_route']} at {launches['forward_by_shape']};"
          f" the DTensor path took {sum(shards)} of {len(shards)} calls")
    print(f"  [{card}] meshed prefill {walls['meshed']['prefill_s']:.4f} s "
          f"(the first on the mesh), decode step median "
          f"{walls['meshed']['decode_step_s_median'] * 1e3:.3f} ms; "
          f"unmeshed prefill {walls['unmeshed']['prefill_s']:.4f} s, decode "
          f"step median {walls['unmeshed']['decode_step_s_median'] * 1e3:.3f}"
          " ms")
    check(logit_err <= MESH_TOL and cache_err <= MESH_TOL
          and meshed["tokens"] == plain["tokens"],
          f"the meshed MoE run differs from the unmeshed one: logits "
          f"{logit_err}, cache {cache_err}, tokens {meshed['tokens']} "
          f"against {plain['tokens']}")
    check(dtensor_leaves > 0, "the meshed run's cache holds no DTensor")
    check(launches["forward_by_route"] == {"tensor_core": n, "fma": 0}
          and shards == [True] * n,
          f"kernel 6 in the meshed prefill: {launches}, DTensor path "
          f"{shards} (want {n} tensor-core launches through the DTensor "
          "path)")
    rows = held_at_path(la, launches["forward_by_shape"],
                        {"local_flash_attention": (kernel6, n)},
                        "meshed MoE prefill")
    return {"arch": MESH_MOE_ARCH, "mesh": list(MESH_SHAPE),
            "prompt_len": PREFILL_L, "new_tokens": MESH_MOE_NEW,
            "logit_difference": logit_err, "cache_difference": cache_err,
            "tokens": meshed["tokens"], "walls": walls,
            "launches": launches, "kernel6": rows["local_flash_attention"]}


def card_roofline(training: dict, serving: dict, card: str) -> dict:
    """Two one-card roofline rows (``devices`` 1) at the H100's constants:
    phase 6's training step (stablelm-1.6b, 4 x 1024 tokens, AdamW, every
    block rematerialized) and phase 5's decode step (4 lanes of 2048),
    each counted on ``meta`` here, beside the phase's measured median wall
    and its profiled device busy time.  No measured wall may fall below
    its bound: if one did, the count or the constants would be wrong.
    The bound's memory term is the bytes the step must move
    (``launch.dryrun.step_bytes_min``); the eager step's counted traffic
    stands beside it."""
    from torch.utils._pytree import tree_leaves
    from repro_torch import configs
    from repro_torch.casestudy.roofline import roofline_row
    from repro_torch.core.profiler import count_step
    from repro_torch.launch.dryrun import (MeshDims, carry_bytes,
                                          step_bytes_min)
    from repro_torch.models import LM, compute_params, param_counts
    from repro_torch.models.params import param_shape_structs
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step

    cfg = configs.get_config(ARCH)
    model = LM(cfg)
    meta = lambda shape: torch.zeros(shape, dtype=torch.int64,
                                     device="meta")
    p_sds = param_shape_structs(cfg)
    opt = adamw(3e-3)
    batch = {"tokens": meta((TRAIN_BATCH, TRAIN_SEQ)),
             "labels": meta((TRAIN_BATCH, TRAIN_SEQ))}
    nbytes = lambda *trees: float(sum(
        t.numel() * t.element_size() for t in tree_leaves(trees)
        if isinstance(t, torch.Tensor)))
    o_sds = opt.init(p_sds)
    train = count_step(make_train_step(model, opt), p_sds, o_sds, batch, 0)
    one = MeshDims({"data": 1, "model": 1}, 1)
    train_min = step_bytes_min(
        "train", nbytes(p_sds, o_sds, batch), nbytes(train.out[:2]), 0.0,
        nbytes(p_sds), carry_bytes(cfg, configs.Shape(
            "phase_train", TRAIN_SEQ, TRAIN_BATCH, "train"), one))
    cache = model.init_cache(SLOTS, MAX_LEN, device="meta")
    c_params, tok = compute_params(cfg, p_sds), meta((SLOTS, 1))
    decode_args = nbytes(c_params, cache, tok)
    decode = count_step(model.decode_step, c_params, cache, tok)
    decode_min = step_bytes_min("decode", decode_args, nbytes(decode.out),
                                nbytes(cache))
    active = param_counts(cfg)[1]
    measured = {
        "train": (training["step_wall_s_median"],
                  training["profiled_step"]["device_busy_ms"] / 1e3,
                  "train", TRAIN_BATCH, TRAIN_SEQ, train, train_min),
        "decode": (statistics.median(serving["unprofiled"]["decode_step_ms"])
                   / 1e3,
                   serving["profiled"]["decode_step"]["device_busy_ms"] / 1e3,
                   "decode", SLOTS, MAX_LEN, decode, decode_min)}
    out = {}
    for name, (wall, busy, kind, batch_n, seq, c, must) in measured.items():
        flops = sum(v for k, v in c.flops.items() if not k.startswith("__"))
        rec = {"cell": f"{ARCH}__phase_{name}__card", "arch": ARCH,
               "shape": f"phase_{name}", "mesh": "card", "devices": 1,
               "kind": kind, "global_batch": batch_n, "seq_len": seq,
               "flops": flops, "jaxpr_flops_global": flops,
               "bytes_accessed": c.bytes, "bytes_accessed_corrected": c.bytes,
               "bytes_min": must, "collective_bytes_total": 0.0,
               "collective_bytes_corrected": 0.0, "params_active": active}
        row = roofline_row(rec)
        bound = row["step_lower_bound_s"]
        out[name] = {"flops": flops, "flops_by_category": c.flops,
                     "bytes": c.bytes, "bytes_min": must, "roofline": row,
                     "measured_wall_s": wall, "device_busy_s": busy,
                     "wall_over_bound": wall / bound,
                     "busy_over_bound": busy / bound if busy else None}
        print(f"  [{card}] one-card roofline, phase "
              f"{'6 training' if name == 'train' else '5 decode'} step: "
              f"FLOPs {flops:.4e}, bytes it must move {must:.4e} (eager "
              f"traffic {c.bytes:.4e}); compute "
              f"{row['compute_s'] * 1e3:.3f} ms, memory "
              f"{row['memory_s'] * 1e3:.3f} ms (eager traffic "
              f"{row['traffic_s'] * 1e3:.3f} ms, not a bound), dominant "
              f"{row['dominant']}, "
              f"bound {bound * 1e3:.3f} ms; measured median wall "
              f"{wall * 1e3:.3f} ms ({wall / bound:.2f}x the bound), device "
              f"busy {busy * 1e3:.3f} ms"
              + (f" ({busy / bound:.2f}x)" if busy else " (not measured)"))
        check(wall >= bound, f"phase {name}'s measured wall {wall} s is "
              f"below its roofline bound {bound} s")
    return out


# --- phase 17: training the MoE, MLA and hybrid families ---------------------

# (arch, the layers kept, batch, sequence), each at its published widths
# and with its depth cut to what one card holds beside AdamW's state (12
# bytes a parameter on the donated step): qwen2-moe-a2.7b's first 4 of 24
# layers (all MoE), deepseek-v3-671b's 3 dense-prefix layers of 61 (MLA,
# d_ff 18432; one MoE layer alone is 11.3 B parameters), recurrentgemma-
# 9b's 5 of 38 (one (rglru, rglru, attn) super-block and the 2-layer
# tail) at 4096 tokens, so that its 2048 window masks; embed and head
# untied in all three
FAMILY_TRAINING = (("qwen2-moe-a2.7b", 4, 4, 1024),
                   ("deepseek-v3-671b", 3, 2, 1024),
                   ("recurrentgemma-9b", 5, 2, 4096))
FAMILY_STEPS = 6
# the train CLI's ``--lr``: at its default, 3e-3, these widths overshoot
# after two updates (1.9 x 3e-3 of summed learning rate) and the loss
# climbs back above its start; the schedule's five updates at 1e-3 sum to
# 3.2e-3
FAMILY_LR = 1e-3


def family_widths(la, cfg) -> tuple[int, int]:
    """Assert ``cfg``'s published widths (the phase 12a and 13 tuples) and
    kernel 6's tensor-core route; returns its (head dim, V width)."""
    if cfg.moe is not None:
        m = cfg.moe
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.vocab_size, cfg.d_ff, cfg.dense_prefix, m.n_routed,
               m.top_k, m.d_expert, m.n_shared) == MOE_WIDTHS[cfg.name],
              f"{cfg.name} is not at its published width and depth")
    else:
        check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.head_dim_, cfg.d_ff, cfg.vocab_size, cfg.local_window,
               cfg.lru_width) == RG_WIDTHS,
              f"{cfg.name} is not at its published width and depth")
    if cfg.mla is not None:
        a = cfg.mla
        check((a.q_lora_rank, a.kv_lora_rank, a.qk_nope_head_dim,
               a.qk_rope_head_dim, a.v_head_dim) == MLA_WIDTHS,
              f"{cfg.name}'s MLA is not at its published width")
        d, dv = a.qk_head_dim, a.v_head_dim
    else:
        d = dv = cfg.head_dim_
    check(la.route(cfg.activation_dtype, d) == "tensor_core",
          f"{cfg.name}'s attention (D {d}) is not on kernel 6's tensor-core "
          "route")
    return d, dv


def repeat_step(model, opt, cfg, batch, dev, step: int) -> dict:
    """The repeat check: from the same params (``init_params`` of SEED)
    and the same batch, ``loss_and_grads`` and one donated AdamW step,
    twice.  The loss, every gradient leaf and every updated parameter must
    be ``torch.equal``.  The first run's gradients and new parameters stay
    on the card while the second runs (16 bytes a parameter at most); the
    second run, its params and state made before, is profiled as one
    training step.  Returns the loss, the leaves compared and the
    profile."""
    from repro_torch.models import init_params
    from repro_torch.models.params import leaves
    from repro_torch.train import loss_and_grads

    def fresh() -> tuple:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), dev)
        return params, opt.init(params)

    def run(params, state) -> tuple:
        loss, _, grads = loss_and_grads(model, params, batch)
        opt.update_(grads, state, params, step)
        return loss, grads, params

    first = run(*fresh())
    second = []
    start = fresh()
    torch.cuda.synchronize()

    def timed() -> float:
        t0 = time.perf_counter()
        second.extend(run(*start))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    profiled = profile_flush(timed, f"{cfg.name} step (loss_and_grads + "
                             "donated AdamW)")
    check(torch.equal(first[0], second[0]), f"{cfg.name} repeat: loss "
          f"{float(first[0])!r} then {float(second[0])!r}")
    out = {"loss": float(first[0]), "profiled_step": profiled}
    for name, a_tree, b_tree in (("gradient", first[1], second[1]),
                                 ("updated parameter", first[2], second[2])):
        pairs = list(zip(leaves(a_tree), leaves(b_tree)))
        differ = [("/".join(k), float((a.float() - b.float()).abs().max()))
                  for (k, a), (_, b) in pairs if not torch.equal(a, b)]
        check(not differ, f"{cfg.name} repeat: {name} leaves differ (leaf, "
              f"max |diff|): {differ}")
        out[f"{name.split()[-1]}_leaves"] = len(pairs)
    return out


def train_family(la, dev, card: str, arch: str, layers: int, batch: int,
                 seq: int) -> dict:
    """One family's training run (``phase_family_training``)."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data import MarkovTask
    from repro_torch.models import LM, init_params, param_counts
    from repro_torch.models.params import leaves
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import loss_and_grads, make_train_step

    full = configs.get_config(arch)
    d, dv = family_widths(la, full)
    cfg = dataclasses.replace(full, n_layers=layers)
    n_params, active = param_counts(cfg)
    kinds = cfg.layer_kinds()
    n_attn = sum(k == "attn" for k in kinds)
    plan = cfg.layer_plan()
    n_remat = plan.n_super * plan.super_block.count("attn")
    moe_layers = sum(cfg.uses_moe_at(i) and k == "attn"
                     for i, k in enumerate(kinds))
    tokens = batch * seq
    print(f"  {arch}: depth cut to {layers} of {full.n_layers} layers at "
          f"full width ({', '.join(kinds)}; {moe_layers} MoE); "
          f"{n_params:,} of {param_counts(full)[0]:,} parameters "
          f"({active:,} active); batch {batch} x {seq} tokens")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held_gb = torch.cuda.memory_allocated(dev) / 1e9
    model = LM(cfg)
    task = MarkovTask(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=SEED)
    opt = adamw(lambda s: warmup_cosine(
        s, peak_lr=FAMILY_LR, warmup_steps=FAMILY_STEPS // 10 + 1,
        total_steps=FAMILY_STEPS))
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         dev)
    state = opt.init(params)
    step_fn = make_train_step(model, opt, donate=True)
    la.reset_launches()
    losses, walls = [], []
    t_run = time.perf_counter()
    for step in range(FAMILY_STEPS):
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state,
                                         task.batch(step, dev), step)
        losses.append(float(metrics["loss"]))
        walls.append(time.perf_counter() - t0)
    run_s = time.perf_counter() - t_run
    fwd = dict(la.local_flash_attention.launches_by_route)
    bwd = dict(la.local_flash_attention.backward_launches_by_route)
    fwd_by_shape = dict(la.local_flash_attention.launches_by_shape)
    bwd_by_shape = dict(la.local_flash_attention.backward_launches_by_shape)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{arch} training losses {losses}: not finite and falling")
    n = n_attn * FAMILY_STEPS
    # the stacked blocks are rematerialized (their attention forward runs
    # twice); the prefix and the tail are not, as in the reference
    n_fwd = (n_attn + n_remat) * FAMILY_STEPS
    check(bwd == {"tensor_core": n, "fma": 0}
          and fwd == {"tensor_core": n_fwd, "fma": 0},
          f"{arch} training: kernel 6 forward {fwd}, backward {bwd}, want "
          f"{n_fwd} and {n} on the tensor-core route")
    h, hkv = batch * cfg.n_heads, batch * cfg.n_kv_heads
    key = la.shape_key(h, hkv, seq, seq, d, True, cfg.local_window)
    check(bwd_by_shape == {key: n} and fwd_by_shape == {key: n_fwd},
          f"{arch} training: kernel 6 forward at {fwd_by_shape}, backward at "
          f"{bwd_by_shape}, want {n_fwd} and {n} at {key}")

    # every gradient leaf finite at the trained params, on the batch of
    # step 1, the first at a nonzero learning rate (the warm-up's step 0
    # has lr 0 and leaves the params as they were): losses[1] is its loss
    # at the initial params
    seen = task.batch(1, dev)
    loss, _, grads = loss_and_grads(model, params, seen)
    bad = ["/".join(k) for k, g in leaves(grads)
           if not bool(torch.isfinite(g).all())]
    check(bool(torch.isfinite(loss)) and not bad,
          f"{arch}: non-finite loss {float(loss)} or gradient leaves {bad}")
    n_leaves = len(list(leaves(grads)))
    del grads, params, state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    repeat = repeat_step(model, opt, cfg, seen, dev, FAMILY_STEPS - 1)
    gc.collect()
    torch.cuda.empty_cache()
    check(repeat["loss"] == losses[1], f"{arch}: step 1's batch at the "
          f"initial params gives {repeat['loss']!r}, the training run's step "
          f"1 read {losses[1]!r}")
    check(float(loss) < losses[1], f"{arch}: the loss on step 1's batch "
          f"did not fall: {losses[1]} at the initial params, {float(loss)} "
          f"after {FAMILY_STEPS} steps")

    step_s = statistics.median(walls[1:])
    flops = 6 * active * tokens
    print(f"  {arch}: loss on step 1's batch at the initial params "
          f"{repeat['loss']:.4f} (as the training run read it), after "
          f"{FAMILY_STEPS} steps {float(loss):.4f}")
    out = {"arch": arch, "layers": layers, "full_layers": full.n_layers,
           "layer_kinds": list(kinds), "moe_layers": moe_layers,
           "rematerialized_attention_layers": n_remat,
           "params": n_params, "active_params": active,
           "full_params": param_counts(full)[0], "batch": batch, "seq": seq,
           "steps": FAMILY_STEPS, "lr": FAMILY_LR, "losses": losses,
           "trained_batch_loss": float(loss),
           "step_wall_s": walls, "step_wall_s_median": step_s,
           "run_wall_s": run_s, "tokens_per_s": tokens / step_s,
           "model_flops_per_step": flops,
           "model_tflops": flops / step_s / 1e12,
           "mfu_bf16": flops / step_s / PEAK_BF16_FLOPS,
           "peak_memory_gb": peak_gb, "held_before_gb": held_gb,
           "gradient_leaves_finite": n_leaves,
           "forward_launches": fwd, "backward_launches": bwd,
           "forward_by_shape": fwd_by_shape,
           "backward_by_shape": bwd_by_shape, "repeat": repeat}
    print(f"  [{card}] {arch}: losses {', '.join(f'{x:.4f}' for x in losses)}"
          f"; step walls (s) {', '.join(f'{w:.4f}' for w in walls)}; median "
          f"of steps 2-{FAMILY_STEPS} {step_s:.4f} s, "
          f"{out['tokens_per_s']:.1f} tokens/s; model FLOP/s (6 N_active T) "
          f"{out['model_tflops']:.2f} TFLOP/s, "
          f"{100 * out['mfu_bf16']:.2f} % of 989 TFLOP/s bf16; peak memory "
          f"{peak_gb:.2f} GB ({held_gb:.2f} GB held before)")
    print(f"  {arch}: kernel 6 forward {fwd}, backward {bwd} at {key}; all "
          f"{n_leaves} gradient leaves finite; repeat step bit-equal (loss, "
          f"{repeat['gradient_leaves']} gradient leaves, "
          f"{repeat['parameter_leaves']} updated parameters)")
    out["kernel6_backward"] = held_at_path(
        la, bwd_by_shape, {
            f"local_flash_attention_backward_{arch}": (attention_case(
                la, dev, h, hkv, seq, d, dv=dv, window=cfg.local_window,
                backward=True), n)},
        f"{arch} training")
    return out


def phase_family_training(la, dev, card: str) -> dict:
    """qwen2-moe-a2.7b, deepseek-v3-671b's dense MLA prefix and
    recurrentgemma-9b at their published widths, depth cut as
    ``FAMILY_TRAINING`` says, one after the other, each taking
    FAMILY_STEPS AdamW steps (``make_train_step(donate=True)``, every
    stacked block rematerialized) of the train CLI's ``MarkovTask`` at
    ``--lr FAMILY_LR``: losses finite and falling, and step 1's batch's
    loss after the run below its value at the initial params, every
    gradient leaf finite, kernel 6's forward and backward on the
    tensor-core route at the one shape each model trains at (the forward
    twice for a stacked layer, once for a prefix or tail one), the repeat
    step bit-equal; kernel 6's backward at that shape beside its plain
    version, SDPA and its bound."""
    return {arch: train_family(la, dev, card, arch, layers, batch, seq)
            for arch, layers, batch, seq in FAMILY_TRAINING}


# --- phase 7: the converter boundary -------------------------------------------


def boundary_inputs(dev) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
    """``BOUNDARY_CASES`` with f32 noise and without."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    inputs = []
    for shape, dtype in BOUNDARY_CASES:
        x = (torch.rand(shape, generator=gen, device=dev) if dtype ==
             torch.float32 else torch.randn(shape, generator=gen,
                                            device=dev)).to(dtype)
        nz = torch.randn(shape, generator=gen, device=dev)
        inputs += [(x, nz), (x, None)]
    torch.cuda.synchronize()
    return inputs


def bit_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal values and NaN in the same places (a NaN's bits may differ)."""
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(got.isnan(), want.isnan())
            and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)))


def check_boundary_specials(cb, dev) -> None:
    """Both routes against the plain version on inputs with NaN, +-inf
    and an all-negative x, in f32 and bf16."""
    rng = np.random.default_rng(SEED + 11)
    for dtype in (torch.float32, torch.bfloat16):
        for case in ("nan x", "nan noise", "inf x", "inf noise", "negative"):
            x = rng.random((513, 1027), dtype=np.float32) * 1.2 - 0.1
            nz = rng.standard_normal(x.shape).astype(np.float32)
            spot = (slice(None, None, 7), slice(2, None, 5))
            if case == "negative":
                x = -x - 0.2
            elif case.endswith("x"):
                x[spot] = np.nan if case == "nan x" else np.inf
            else:
                nz[spot] = np.nan if case == "nan noise" else -np.inf
            xt = torch.from_numpy(x).to(device=dev, dtype=dtype)
            nt = torch.from_numpy(nz).to(dev)
            want = cb.converter_boundary_plain(xt, nt, dac_bits=6,
                                               adc_bits=8, noise_std=0.02)
            for route in cb.ROUTES:
                got = torch.empty_like(xt)
                cb._launch(xt, nt, got, route, 6, 8, 0.02)
                check(bit_equal(got, want), f"converter_boundary {route} "
                      f"{dtype} {case}: not bit-equal to the plain version")


def phase_boundary(cb, ops, dev, card: str) -> dict:
    """``ops.converter_boundary`` at its shapes with and without noise:
    launches counted, each on the resident route, bit-equal to the plain
    version (and so is the streamed route through the C entry point, and
    both on NaN, inf and all-negative inputs; a call is one launch of the
    resident kernel, by the profiler's count of launch API calls).  Times
    per case and route: device time per call from CUDA events with the
    card held busy while the host queues (``held_ms``; launch gaps count),
    with L2 cleared before each call and back to back, the kernel alone
    under torch.profiler beside it, and the event-timed wall of a call,
    against the bytes bound (x and noise read once, out written
    once); 24-bit converters (IEEE divides, no code table) beside 8-bit on
    the resident route.  "L2 cleared" reads a 256 MiB buffer before each
    call; a rewrite of it ("dirty") adds that buffer's write-back to the
    call."""
    inputs = boundary_inputs(dev)
    adc_bits = dac_bits = 8
    kw = dict(dac_bits=dac_bits, adc_bits=adc_bits,
              noise_std=BOUNDARY_NOISE_STD)
    cb.reset_launches()
    outs = [ops.converter_boundary(x, nz, **kw) for x, nz in inputs]
    torch.cuda.synchronize()
    launches = cb.converter_boundary.launches
    by_route = dict(cb.converter_boundary.launches_by_route)
    check(launches == len(inputs) and by_route["resident"] == launches,
          f"converter_boundary launched {by_route} for {len(inputs)} calls "
          "(all resident expected)")
    check_boundary_specials(cb, dev)
    # L2 cleared before a call: a 256 MiB buffer read (the call finds
    # clean lines of another buffer) or rewritten (it finds them dirty,
    # and their write-back to HBM falls into the call)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    clean, dirty = scratch.amax, scratch.bitwise_not_
    err, rows = 0.0, []
    for (x, nz), got in zip(inputs, outs):
        want = cb.converter_boundary_plain(x, nz, **kw)
        out = torch.empty_like(x)
        streamed = lambda: cb._launch(x, nz, out, "streamed", dac_bits,
                                      adc_bits, BOUNDARY_NOISE_STD)
        streamed()
        e = float((got.float() - want.float()).abs().max())
        tag = (f"converter_boundary {tuple(x.shape)} {x.dtype} noise "
               f"{nz is not None}")
        check(bit_equal(got, want), f"{tag}: resident route not bit-equal "
              f"to the plain version (max |err| {e:.3e})")
        check(bit_equal(out, want), f"{tag}: streamed route not bit-equal "
              "to the plain version")
        err = max(err, e)
        kern = lambda: ops.converter_boundary(x, nz, **kw)
        wide = lambda: ops.converter_boundary(x, nz, dac_bits=24,
                                              adc_bits=24,
                                              noise_std=BOUNDARY_NOISE_STD)
        plain = lambda: cb.converter_boundary_plain(x, nz, **kw)
        wall = [median_ms(kern), median_ms(plain), median_ms(plain),
                median_ms(kern)]
        kernel_ms, by_name, api = device_profile(kern)
        check(api == {"cudaLaunchCooperativeKernel": 1}
              and all("boundary_resident_kernel" in k for k in by_name),
              f"{tag}: a call made {api}, kernels {list(by_name)}, not one "
              "launch of the resident kernel")
        cleared = held_ms(kern, flush=clean)
        s_names = device_profile(streamed)[1]
        nbytes = 2 * x.numel() * x.element_size() + (
            0 if nz is None else nz.numel() * nz.element_size())
        row = {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
               "noise": nz is not None, "max_abs_err": e,
               "bit_equal_to_plain": True,
               # device time of a wrapper call: the resident kernel alone
               "ms": held_ms(kern), "l2_cleared_ms": cleared,
               "l2_dirty_ms": held_ms(kern, flush=dirty),
               "plain_ms": held_ms(plain, flush=clean),
               "plain_back_to_back_ms": held_ms(plain),
               # the kernel's own time under torch.profiler (no launch
               # gaps; None where the tracer lost the window)
               "kernel_only_ms": kernel_ms,
               "kernel_l2_cleared_ms": device_profile(kern, flush=clean)[0],
               "launch_calls": api,
               "bits24_ms": held_ms(wide, flush=clean),
               "streamed_ms": held_ms(streamed),
               "streamed_l2_cleared_ms": held_ms(streamed, flush=clean),
               "streamed_by_kernel_ms": {
                   n: v for k, v in s_names.items() for n in BOUNDARY_KERNELS
                   if n in k},
               "wall_ms": statistics.mean((wall[0], wall[3])),
               "plain_wall_ms": statistics.mean((wall[1], wall[2])),
               "bound_ms": nbytes / PEAK_BYTES_S * 1e3, "bytes": nbytes}
        row["bound_share"] = (row["bound_ms"] / cleared if cleared
                              else None)
        rows.append(row)
        f = {k: "n/a" if v is None else f"{v:.4f}" for k, v in row.items()
             if k.endswith(("ms", "share")) and not isinstance(v, dict)}
        print(f"  [{card}] {tag}: resident device time per call "
              f"{f['ms']} ms back to back, {f['l2_cleared_ms']} ms L2 "
              f"cleared (kernel alone {f['kernel_only_ms']} / "
              f"{f['kernel_l2_cleared_ms']} ms; {f['bound_share']} of the "
              f"bound {f['bound_ms']} ms, bytes), {f['l2_dirty_ms']} ms "
              f"after a dirty flush, 24-bit converters {f['bits24_ms']} ms; "
              f"streamed {f['streamed_ms']} / {f['streamed_l2_cleared_ms']}"
              f" ms {row['streamed_by_kernel_ms']}; plain {f['plain_ms']} "
              f"ms; event-timed wall {f['wall_ms']} ms, plain "
              f"{f['plain_wall_ms']} ms; bit-equal on both routes")
    del scratch
    main = rows[0]
    return {"name": "converter_boundary", "route": "cuda",
            "source": ADC_SOURCE, "replaces": REPLACES["converter_boundary"],
            "launches": launches, "launches_by_route": by_route,
            "max_abs_err": err, "ms": main["l2_cleared_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "shape": main["shape"], "dtype": main["dtype"],
            "noise_std": BOUNDARY_NOISE_STD, "at": rows}


# --- phase 8: the sharded runtime ----------------------------------------------

def timed_flush(ex, frames) -> tuple[float, list]:
    t0 = time.perf_counter()
    hs = [ex.submit("fft", x) for x in frames]
    ex.flush_async()
    for h in hs:
        h.wait()
    return (time.perf_counter() - t0) * 1e3, hs


def sharded_flush(rt, od, dev, frames, want) -> dict:
    """The offload path's flush through the sharded backend (phase 3's
    spec, group, window and budget), bit-equal to phase 3's frames, then
    its wall and device time beside the unsharded flush's, in turns."""
    from repro_torch.distributed.sharding import shard_devices
    spec = rt.BATCHED_4F
    ex = rt.OffloadExecutor(spec, max_batch=FRAMES, pipeline_depth=2,
                            n_devices=SHARDS, default_backend="sharded")
    placed = shard_devices(SHARDS, ex.device) is not None
    route = ("placed: one card per shard" if placed else
             f"sequential: {SHARDS} logical devices in turn on {ex.device}")
    tile = ex.resolve_tile_k("fft", frames[0], FRAMES)
    ex.warm("fft", frames[0], batch=FRAMES)
    torch.cuda.synchronize()

    od.reset_launches()
    wall_ms, hs = timed_flush(ex, frames)
    launches, by_route = dft_counts(od)
    print(f"  route {route}; tile_k {tile}; launches {launches}, by route "
          f"{by_route}; first sharded flush wall {wall_ms:.3f} ms")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the sharded path")
        check(by_route[name] == {"tensor_core": n, "fma": 0},
              f"{name}: a sharded launch left the tensor-core route: "
              f"{by_route[name]}")
    for i, (h, w) in enumerate(zip(hs, want)):
        check(h.value.device == dev and h.backend == "sharded",
              f"frame {i}: on {h.value.device}, served by {h.backend}")
        check(torch.equal(h.value, w),
              f"frame {i}: the sharded flush differs from the unsharded "
              f"one by {float((h.value - w).abs().max()):.3e}")
    observed = ex.telemetry.devices_observed("fft")
    check(observed == min(SHARDS, tile),
          f"{observed} devices observed, {min(SHARDS, tile)} expected")
    per_device = ex.telemetry.device_samples("fft")
    print(f"  bit-equal to phase 3's frames; per-device samples "
          f"{per_device}")

    single = rt.OffloadExecutor(spec, max_batch=FRAMES, pipeline_depth=2)
    single.warm("fft", frames[0], backend="optical-sim", batch=FRAMES)
    walls = {"unsharded": [], "sharded": []}
    for name in ("unsharded", "sharded", "sharded", "unsharded"):
        run = single if name == "unsharded" else ex
        walls[name] += [timed_flush(run, frames)[0] for _ in range(5)]
    profiled = {name: profile_flush(
        lambda run=run: timed_flush(run, frames)[0], f"{name} flush")
        for name, run in (("unsharded", single), ("sharded", ex))}
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(f"  repeat flush walls (10 each, in turns): unsharded median "
          f"{med['unsharded']:.3f} ms, sharded {med['sharded']:.3f} ms")
    ex.close()
    single.close()
    return {"route": route, "placed": placed, "tile_k": tile,
            "launches": launches, "launches_by_route": by_route,
            "devices_observed": observed,
            "per_device_samples": {str(k): v for k, v in per_device.items()},
            "first_flush_wall_ms": wall_ms, "repeat_walls_ms": walls,
            "repeat_wall_median_ms": med, "profiled": profiled}


def conv_kernel(shape) -> np.ndarray:
    """A 5x5 kernel and two wrap-around rows, so a row tile needs halo
    rows above and below it."""
    rng = np.random.default_rng(SEED + 8)
    k = np.zeros(shape, np.float32)
    k[:5, :5] = 0.04 * rng.standard_normal((5, 5)).astype(np.float32)
    k[0, 0] += 0.5
    k[-1, 1], k[-2, 0] = 0.15, 0.1
    return k


def frame_sharded_conv(rt, dev) -> dict:
    """One conv frame larger than the SLM's aperture, row-tiled over the
    devices by overlap-save (``shard_mode`` auto picks frame sharding):
    ``sharded-host`` against the unsharded host conv at the reference's
    frame-sharding bound of the ``host`` backend (rtol 1e-4, atol 1e-5);
    ``sharded`` (the optical simulator, each tile's detector
    auto-exposing its own rows) against the host conv within the ENOB
    bound the fidelity shadow applies.  The reference's 2 % bound between
    sharded and unsharded optical conv holds at its tests' frame sizes; at
    this size the two differ by ~9 %, each within the ENOB bound of the
    host's (the unsharded ~8 %, the sharded ~5 %)."""
    spec = rt.BATCHED_4F
    check(FRAME_SHARDED[0] * FRAME_SHARDED[1] > spec.usable_pixels,
          "the frame-sharded conv's frame fits the aperture")
    rng = np.random.default_rng(SEED + 9)
    frame = rng_frames(rng, FRAME_SHARDED, dev)
    kernel = torch.from_numpy(conv_kernel(FRAME_SHARDED)).to(dev)
    out = {}
    for backend, single in (("sharded-host", "host"),
                            ("sharded", "optical-sim")):
        ex = rt.OffloadExecutor(spec, max_batch=1, n_devices=SHARDS,
                                default_backend=backend)
        ex.warm("conv", frame, kernel=kernel, batch=1)
        ex.warm("conv", frame, kernel=kernel, backend=single, batch=1)
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = ex.run("conv", frame, kernel=kernel)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        want = ex.run("conv", frame, kernel=kernel, backend=single)
        host = ex.run("conv", frame, kernel=kernel, backend="host")
        samples = ex.telemetry.device_samples("conv")
        check(len(samples) == SHARDS and got.shape == FRAME_SHARDED
              and bool(torch.isfinite(got).all()),
              f"{backend}: {len(samples)} devices, shape "
              f"{tuple(got.shape)}")
        if backend == "sharded-host":
            err = max_violation(got, want, 1e-4, 1e-5)
            check(err <= 0.0, f"{backend}: {err:.3e} past rtol 1e-4, "
                  "atol 1e-5 of the unsharded host conv")
            bound = "rtol 1e-4, atol 1e-5"
            err = float((got - want).abs().max())
        else:
            enob = min(spec.dac.effective_bits, spec.adc.effective_bits)
            report = rt.FidelityChecker().check("conv", backend, [got],
                                                [host], enob=enob)
            check(report.ok, f"{backend}: {report}")
            bound = (f"vs host: relative norm {report.rel_err:.3e} within "
                     f"the ENOB bound {report.bound:.3e}")
            err = float((got - want).norm() / want.norm())
        med = statistics.median(walls)
        print(f"  frame-sharded conv {FRAME_SHARDED} on {backend}: wall "
              f"median {med:.3f} ms (5 calls), vs {single}: "
              f"{err:.3e} ({bound}); per-device samples {samples}")
        out[backend] = {"walls_ms": walls, "wall_median_ms": med,
                        "err_vs_unsharded": err, "bound": bound,
                        "per_device_samples": {str(k): v for k, v in
                                               samples.items()}}
        ex.close()
    return out


def chaos_run(rt, dev, frames, want, hosts) -> dict:
    """``register_chaos("sharded", rate=0.3, seed=0)`` under a ManualClock
    with the fidelity shadow on, flush after flush (the clock moved on 1 s
    between them, past every quarantine) until a device loss, a straggle
    and a drift have each been injected.  Every frame retires: frames the
    chaos backend served are bit-equal to phase 3's, frames the host
    served (retry exhaustion, quarantine reroutes, drift corrected from
    the shadow) equal the host backend's."""
    spec = rt.BATCHED_4F
    name = rt.register_chaos("sharded", rate=0.3, seed=0)
    clk = rt.ManualClock()
    ex = rt.OffloadExecutor(spec, default_backend=name, max_batch=FRAMES,
                            pipeline_depth=2, n_devices=SHARDS, clock=clk,
                            fidelity=rt.FidelityChecker())
    ex.warm("fft", frames[0], batch=FRAMES)
    served = {"chaos": 0, "host": 0}
    walls, flushes = [], 0
    counts = {}
    while flushes < CHAOS_FLUSHES:
        wall_ms, hs = timed_flush(ex, frames)
        walls.append(wall_ms)
        flushes += 1
        for i, h in enumerate(hs):
            v = h.value
            check(h.ready and v is not None and v.shape == (SIDE, SIDE)
                  and bool(torch.isfinite(v).all()),
                  f"chaos flush {flushes}, frame {i} did not retire whole")
            if h.backend == name:
                check(torch.equal(v, want[i]), f"chaos flush {flushes}, "
                      f"frame {i}: differs from the unfaulted flush")
                served["chaos"] += 1
            else:
                check(h.backend == "host", f"served by {h.backend}")
                top = float(hosts[i].abs().max())
                err = float((v - hosts[i]).abs().max())
                check(err <= 1e-5 * top, f"chaos flush {flushes}, frame "
                      f"{i}: host-served {err:.3e} off the host's")
                served["host"] += 1
        counts = dict(ex.telemetry.fault_counts.get("fft", {}))
        clk.advance(1.0)
        if all(counts.get(k, 0) for k in ("device_loss", "straggle",
                                          "drift")):
            break
    recovery = ex.telemetry.recovery_stats("fft")
    events = [(str(e.key), e.reason) for e in ex.quarantine.events]
    print(f"  chaos: {flushes} flushes of {FRAMES}, every frame retired "
          f"({served}); faults {counts}; recovery {recovery} "
          f"(ManualClock s: backoffs; a drift's recovery is the shadow's "
          f"host time); quarantines {len(events)}; walls "
          f"{[round(w, 3) for w in walls]} ms")
    for k in ("device_loss", "straggle", "drift"):
        check(counts.get(k, 0) > 0, f"no {k} fault in {flushes} flushes")
    check(bool(ex.fidelity.violations("fft")),
          "the fidelity shadow caught no drift")
    ex.close()
    return {"flushes": flushes, "served": served, "faults": counts,
            "recovery": recovery, "quarantines": events,
            "walls_ms": walls}


def traced_flush(rt, dev, frames, want) -> dict:
    """A traced sharded flush in tiles of ``SHARDS`` frames (so every
    tile scatters over all four devices), written with ``write_trace``
    under ``build/`` and loaded back: one named lane per device, and the
    charged stage sums reconciled with the measured wall."""
    import tempfile
    spec = rt.BATCHED_4F
    tracer = rt.Tracer()
    ex = rt.OffloadExecutor(spec, max_batch=FRAMES, pipeline_depth=2,
                            n_devices=SHARDS, default_backend="sharded",
                            tile_k=SHARDS, tracer=tracer)
    ex.warm("fft", frames[0], batch=FRAMES)
    torch.cuda.synchronize()
    tracer.clear()
    hs = [ex.submit("fft", x) for x in frames]
    t0 = time.perf_counter()       # the flush alone, as reconcile's gate
    ex.flush()
    wall_ms = (time.perf_counter() - t0) * 1e3
    for i, (h, w) in enumerate(zip(hs, want)):
        check(torch.equal(h.value, w), f"traced flush, frame {i}: "
              "differs from the unsharded flush")
    spans = tracer.spans()
    rec = rt.reconcile(spans, wall_ms / 1e3)
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=TRACE_DIR) as tmp:
        path = Path(tmp) / "sharded_flush.json"
        rt.write_trace(str(path), spans)
        size = path.stat().st_size
        loaded = json.loads(path.read_text())
    lanes = [e["args"]["name"] for e in loaded["traceEvents"]
             if e["ph"] == "M"]
    # "device" is the executor's compute lane, "device<d>" a shard's
    devices = sorted(la for la in lanes if la[6:].isdigit())
    check(devices == [f"device{d}" for d in range(SHARDS)]
          and len(lanes) == len(set(lanes)),
          f"trace lanes {lanes}: not one named lane per device")
    scatters = [s for s in spans if s.name == "scatter"]
    print(f"  traced flush: wall {wall_ms:.3f} ms, {len(spans)} spans, "
          f"{len(scatters)} scatter spans, trace {size} bytes, lanes "
          f"{lanes}; reconcile coverage {rec['coverage']:.4f} (stage "
          f"{rec['stage'] * 1e3:.3f} ms, compute {rec['compute'] * 1e3:.3f}"
          f" ms)")
    print("  " + rt.summarize(spans).replace("\n", "\n  "))
    ex.close()
    return {"wall_ms": wall_ms, "spans": len(spans), "lanes": lanes,
            "trace_bytes": size,
            "reconcile": {k: v for k, v in rec.items()}}


def phase_sharded(rt, od, dev, main: dict, card: str) -> dict:
    frames, want, hosts = (main.pop("_frames"), main.pop("_values"),
                           main.pop("_hosts"))
    return {"card": card,
            "flush": sharded_flush(rt, od, dev, frames, want),
            "frame_conv": frame_sharded_conv(rt, dev),
            "chaos": chaos_run(rt, dev, frames, want, hosts),
            "trace": traced_flush(rt, dev, frames, want)}


# --- phase 9: the paper's case study --------------------------------------------


def recording_profiler(log: list):
    """An ``OpProfiler`` class whose instances append themselves to
    ``log`` and check every bracketed call's tensors lie on the card.
    Outside a timed session (the suite's warm-up run) each also keeps its
    first call and whether each output is finite; inside one it adds
    nothing to the device's queue, so the timed runs measure the suite
    alone."""
    from torch.utils import _pytree as pytree
    from repro_torch.core.profiler import OpProfiler

    class Recording(OpProfiler):
        def __init__(self):
            super().__init__()
            self.first = None
            self.finite = []
            log.append(self)

        def run(self, category, fn, *args, **kwargs):
            out = super().run(category, fn, *args, **kwargs)
            tensors = [t for t in pytree.tree_leaves((args, kwargs, out))
                       if isinstance(t, torch.Tensor)]
            check(all(t.is_cuda for t in tensors),
                  f"a bracketed {category} call has a tensor off the card")
            if self._t0 is None:
                self.finite.append(torch.isfinite(out).all())
                if self.first is None:
                    self.first = (fn, args, kwargs, out)
            return out
    return Recording


def casestudy_counts(prof) -> dict:
    return {c: (prof.calls[c], prof.samples_in[c], prof.samples_out[c])
            for c in prof.calls}


def replay_on_cpu(first) -> tuple[float, float]:
    """The card's first bracketed call again on the CPU, on copies of its
    inputs: (max |card - cpu|, the bound)."""
    from torch.utils import _pytree as pytree
    fn, args, kwargs, out = first
    to_cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    want = fn(*pytree.tree_map(to_cpu, args),
              **pytree.tree_map(to_cpu, kwargs))
    check(want.dtype == out.dtype and want.shape == out.shape,
          f"card {out.dtype} {tuple(out.shape)} vs cpu {want.dtype} "
          f"{tuple(want.shape)}")
    err = float((out.cpu() - want).abs().max())
    return err, CASESTUDY_REL * float(want.abs().max())


def lm_flops(cfg, params, batch) -> dict:
    from repro_torch.core.profiler import flops_by_category
    from repro_torch.models import LM
    model = LM(cfg)
    return flops_by_category(lambda p, b: model.loss(p, b)[0], params, batch)


def on_meta(cfg, batch: int, seq: int) -> tuple[dict, dict]:
    """Parameters and a token batch of ``cfg`` on the meta device."""
    from repro_torch.models.config import torch_dtype
    from repro_torch.models.params import map_tree, model_templates
    params = map_tree(lambda s: torch.empty(
        s.shape, dtype=torch_dtype(s.dtype or cfg.param_dtype),
        device="meta"), model_templates(cfg))
    tokens = torch.zeros((batch, seq), dtype=torch.long, device="meta")
    return params, {"tokens": tokens, "labels": tokens}


def casestudy_flops(la, dev) -> dict:
    """The FLOP count of the smoke loss on the card (its attention through
    kernel 6) and on meta, and of the full-width loss on meta."""
    from repro_torch import configs
    from repro_torch.models import init_params

    cfg = configs.get_smoke_config(ARCH)
    b, s = 2, 32                               # the planner's trace shape
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_params(cfg, gen, device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev)
    la.reset_launches()
    on_card = lm_flops(cfg, params, {"tokens": tokens, "labels": tokens})
    launches = dict(la.local_flash_attention.launches_by_route)
    meta = lm_flops(cfg, *on_meta(cfg, b, s))
    offload = lambda c: {k: c.get(k, 0.0) for k in ("matmul", "conv", "fft")}
    print(f"  {ARCH} smoke loss ({b} x {s} tokens): cuda {on_card}, meta "
          f"{meta}; kernel 6 launches {launches}")
    check(sum(launches.values()) == cfg.n_layers,
          f"the smoke loss launched kernel 6 {launches} times on the card "
          f"(want {cfg.n_layers}: one a layer)")
    check(offload(on_card) == offload(meta) and on_card["matmul"] > 0,
          f"matmul/conv/fft FLOPs differ between cuda {on_card} and meta "
          f"{meta}")
    full = configs.get_config(ARCH)
    t0 = time.perf_counter()
    full_meta = lm_flops(full, *on_meta(full, TRAIN_BATCH, TRAIN_SEQ))
    print(f"  {ARCH} full-width loss ({TRAIN_BATCH} x {TRAIN_SEQ} tokens) "
          f"on meta: {full_meta} ({time.perf_counter() - t0:.2f} s)")
    return {"smoke_cuda": on_card, "smoke_meta": meta,
            "smoke_launches": launches, "full_meta": full_meta}


def phase_casestudy(od, la, dev, card: str) -> dict:
    """Table 1 on the card: the 27-benchmark suite through ``run_suite``,
    every bracketed call checked, each benchmark's first call held to the
    CPU; Fig. 8's software FFT; the FLOP count across devices."""
    from repro_torch.casestudy import amdahl_suite as suite
    from repro_torch.casestudy import conversion_bottleneck as fig8
    from repro_torch.kernels import adc_dac as cb

    t0 = time.perf_counter()
    log: list = []
    for reset in (od.reset_launches, la.reset_launches, cb.reset_launches):
        reset()
    rows = suite.run_suite(device=dev, profiler=recording_profiler(log))
    torch.cuda.synchronize()
    suite_s = time.perf_counter() - t0
    launches = {"dft_stage1_batched": od.dft_stage1_batched.launches,
                "dft_stage2_batched": od.dft_stage2_batched.launches,
                "local_flash_attention": la.local_flash_attention.launches,
                "converter_boundary": cb.converter_boundary.launches}
    check(not any(launches.values()),
          f"the case study launched a hand-written kernel: {launches}")
    check(len(log) == 2 * len(rows) == 2 * len(suite.BENCHMARKS),
          f"{len(log)} profilers for {len(rows)} benchmarks")

    table = []
    for i, row in enumerate(rows):
        warm, timed = log[2 * i], log[2 * i + 1]
        want = CASESTUDY_COUNTS[row.name]
        check(casestudy_counts(warm) == want,
              f"{row.name}: calls/samples {casestudy_counts(warm)}, "
              f"want {want}")
        check(casestudy_counts(timed) == {
            c: tuple(suite.REPEATS * n for n in v) for c, v in want.items()},
              f"{row.name}: the timed runs bracketed "
              f"{casestudy_counts(timed)}")
        check(bool(torch.stack(warm.finite).all()),
              f"{row.name}: a bracketed output is not finite")
        err, bound = replay_on_cpu(warm.first)
        check(err <= bound, f"{row.name}: card vs cpu {err:.3e} > "
                            f"{bound:.3e}")
        paper_pct, paper_s = suite.PAPER_TABLE1[row.name]
        table.append({"name": row.name, "total_s": row.total_time_s,
                      "accel_s": row.accel_time_s,
                      "fraction": row.fraction,
                      "speedup": row.end_to_end_speedup,
                      "paper_fraction": paper_pct / 100,
                      "paper_speedup": paper_s,
                      "first_call_err": err, "first_call_bound": bound})
    speedups = sorted(r["speedup"] for r in table)
    median = speedups[len(speedups) // 2]
    mean = sum(speedups) / len(speedups)
    print(f"  [{card}] Table 1 ({suite.REPEATS} timed runs after a warm-up):")
    print("  benchmark, total ms, fft/conv %, ideal speedup, paper %, "
          "paper speedup")
    for r in table:
        print(f"  {r['name']}, {1e3 * r['total_s']:.4f}, "
              f"{100 * r['fraction']:.2f}, {r['speedup']:.3f}x, "
              f"{100 * r['paper_fraction']:.2f}, {r['paper_speedup']:.2f}x")
    print(f"  MEDIAN {median:.3f}x (paper {PAPER_MEDIAN}x), MEAN "
          f"{mean:.3f}x (paper {PAPER_MEAN}x); every bracketed call on "
          f"the card, counts equal the reference's, first calls within "
          f"{CASESTUDY_REL}*max of the CPU")

    r8 = fig8.run(dev)
    print(f"  [{card}] Fig. 8: software fft2 of {fig8.FRAME} "
          f"{1e6 * r8['software_fft_s']:.2f} us on the card; modelled "
          f"prototype {r8['hardware_total_s']:.4f} s "
          f"({r8['hardware_movement_pct']:.3f} % data movement), "
          f"{r8['hardware_vs_software']:.1f}x slower (paper "
          f"{r8['paper_hardware_vs_software']:.1f}x on a Raspberry Pi 4); "
          f"sim intensity error {r8['sim_intensity_rel_err']:.3e}")
    check(all(np.isfinite([r8["software_fft_s"],
                           r8["sim_intensity_rel_err"]])),
          f"Fig. 8 is not finite: {r8}")

    flops = casestudy_flops(la, dev)
    planner = planner_rows()
    wall = time.perf_counter() - t0
    print(f"  [{card}] phase wall {wall:.2f} s (suite {suite_s:.2f} s)")
    return {"card": card, "table1": table, "median": median, "mean": mean,
            "paper_median": PAPER_MEDIAN, "paper_mean": PAPER_MEAN,
            "fig8": r8, "flops": flops, "planner": planner,
            "suite_wall_s": suite_s, "phase_wall_s": wall}


def planner_rows() -> list[dict]:
    """The planner table's rows (its counts on meta), host seconds priced
    at the H100's dense bf16 peak."""
    from repro_torch.casestudy import planner_table as planner
    check(planner.HOST_PEAK == PEAK_BF16_FLOPS,
          f"the planner prices at {planner.HOST_PEAK}, not the H100's bf16 "
          f"peak {PEAK_BF16_FLOPS}")
    rows = planner.run()
    print(f"  planner table at {planner.HOST_PEAK:.3g} FLOP/s (H100 bf16):")
    for r in rows:
        check(r["mvm_speedup"] >= 1.0 and r["fourier_speedup"] >= 1.0,
              f"planner row {r}")
        print(f"  planner,{r['arch']},mvm={r['mvm_speedup']:.4f}x"
              f"|fourier={r['fourier_speedup']:.4f}x"
              f"|matmul_flops={r['flops_pct'].get('matmul', 0.0):.2f}%"
              f"|worthwhile={r['mvm_worthwhile']}"
              f"|conversion_bound={r['mvm_conversion_bound']}")
    return rows


# --- phase 10: the runtime bench and the examples ----------------------------

# The columns of casestudy/runtime_bench.py's payload, each run once by
# bench_payload(); and each frame shape the bench flushes through the DFT
# kernels with the deepest group it dispatches there.
BENCH_COLUMNS = ("roundtrip", "sweep", "pipeline_comparison",
                 "sharded_comparison", "trickle_comparison",
                 "large_frame_comparison", "traced_comparison",
                 "chaos_comparison", "chaos_overhead", "residency_comparison")
BENCH_SHAPES = {(64, 64): 8, (128, 128): 16, (256, 256): 16, (512, 512): 16}
# the reference's CI gates that time walls: printed with their verdicts
TRACER_OVERHEAD_BOUND, CHAOS_OVERHEAD_BOUND = 0.05, 0.02


def dft_routes(od) -> dict:
    return {n: dict(getattr(od, n).launches_by_route) for n in DFT_STAGES}


def routes_since(od, before: dict) -> dict:
    return {n: {r: c - before[n][r] for r, c in routes.items()}
            for n, routes in dft_routes(od).items()}


def bench_by_column(rb, od, dev) -> tuple[dict, dict]:
    """``rb.bench_payload(dev)``, and the DFT launches by route that each
    of its columns made (each column wrapped while the payload runs)."""
    by_column, saved = {}, {n: getattr(rb, n) for n in BENCH_COLUMNS}

    def counted(name, fn):
        def column(*args, **kwargs):
            before = dft_routes(od)
            out = fn(*args, **kwargs)
            by_column[name] = routes_since(od, before)
            return out
        return column
    try:
        for name, fn in saved.items():
            setattr(rb, name, counted(name, fn))
        payload = rb.bench_payload(dev)
    finally:
        for name, fn in saved.items():
            setattr(rb, name, fn)
    return payload, by_column


def check_bench_gates(p: dict) -> None:
    """The reference CI's asserts that are deterministic or guard
    correctness, and batched < looped at 128^2 x 16."""
    sweep = {r["max_batch"]: r for r in p["sweep"]}
    check(sweep[16]["wall_s_per_call"] < sweep[1]["wall_s_per_call"],
          f"batched {sweep[16]['wall_s_per_call']:.3e} s/call is not under "
          f"looped {sweep[1]['wall_s_per_call']:.3e} at 128^2 x 16")
    shard = {r["n_devices"]: r for r in p["sharded"]}
    check(shard[4]["modeled_s_per_call"] <= shard[1]["modeled_s_per_call"],
          f"sharded modeled {shard[4]['modeled_s_per_call']} > single "
          f"{shard[1]['modeled_s_per_call']}")
    t = p["trickle_comparison"]
    check(t["held_occupancy"] > t["drain_occupancy"]
          and t["held_samples_per_crossing"]
          > t["drain_samples_per_crossing"], f"trickle: {t}")
    check(p["large_frame"]["tile_matches_dispatch"],
          f"large frame: tile {p['large_frame']['chosen_tile_k']} chosen, "
          f"{p['large_frame']['dispatched_tile_sizes']} dispatched")
    rows = p["chaos"]["rows"]
    for r in rows:
        check(r["all_retired"] and r["within_bound"], f"chaos row {r}")
    check(any(r["faults_total"] > 0 for r in rows if r["fault_rate"] > 0),
          "no fault injected at a non-zero rate")
    res = p["residency"]
    check(res["modeled_hit_dac_s"] == 0.0
          and 0.0 < res["modeled_delta_dac_s"] < res["modeled_restage_dac_s"]
          and res["hit_rate"] > 0.5
          and 0.0 < res["delta_flip_fraction"] < 0.35
          and res["bit_equal_to_plain"] and res["delta_bit_equal_to_plain"],
          f"residency: {res}")
    check(p["traced"]["reconcile"]["coverage"] > 0.5,
          f"traced coverage {p['traced']['reconcile']}")
    check(p["roundtrip"]["decisions_match_execution"],
          f"roundtrip: {p['roundtrip']}")


def timing_gates(rb, p: dict) -> list[dict]:
    """The reference CI's timing gates, each with its value, its bound
    and whether it held on this card (printed, not asserted)."""
    lf, tc, co, res = (p["large_frame"], p["traced"], p["chaos_overhead"],
                       p["residency"])
    gates = []
    if lf["chosen_tile_k"] < lf["calls"]:
        gates.append({"gate": "large frame tiled <= monolithic (s/call)",
                      "value": lf["tiled_wall_s_per_call"],
                      "bound": lf["monolithic_wall_s_per_call"],
                      "held": lf["tiled_wall_s_per_call"]
                      <= lf["monolithic_wall_s_per_call"]})
    gates.append({"gate": "tracer overhead < 5 %",
                  "value": tc["tracer_overhead"],
                  "bound": TRACER_OVERHEAD_BOUND,
                  "held": tc["tracer_overhead"] < TRACER_OVERHEAD_BOUND})
    gates.append({"gate": "rate-0 chaos wrapper overhead < 2 %",
                  "value": co["overhead"], "bound": CHAOS_OVERHEAD_BOUND,
                  "held": co["overhead"] < CHAOS_OVERHEAD_BOUND})
    walls = [res[f"{k}_wall_s_per_call"] for k in ("hit", "delta", "restage")]
    gates.append({"gate": "residency hit < delta < restage (s/call)",
                  "value": walls, "bound": "strictly increasing",
                  "held": walls[0] < walls[1] < walls[2]})
    ok, msg = rb.drift_gate(tc["drift"], [])
    gates.append({"gate": "drift_gate (no history on a fresh machine)",
                  "value": tc["drift"]["stages"].get("stage", {})
                  .get("drift"), "bound": list(rb.DRIFT_BAND), "held": ok,
                  "message": msg})
    return gates


def check_bench_frames(rt, rb, od, dev) -> dict:
    """At each frame shape the bench flushes, on the bench's frames: the
    batched flush bit-equal to the frames flushed one at a time, and to
    the ADC of the DFT kernels' outputs, which are within the reference's
    bounds of their plain versions."""
    from repro_torch.core.optical import adc_quantize_batched

    spec = rt.BATCHED_4F
    errs = {}
    for (h, w), k in BENCH_SHAPES.items():
        frames = rb._images(k, (h, w), dev)
        flushed = {}
        for mb in (k, 1):
            ex = rt.OffloadExecutor(spec, max_batch=mb, device=dev,
                                    mem_budget=rt.MemoryBudget.unlimited())
            hs = [ex.submit("fft", f) for f in frames]
            ex.flush()
            flushed[mb] = [r.value for r in hs]
        for i, (a, b) in enumerate(zip(flushed[k], flushed[1])):
            check(torch.equal(a, b), f"{h}x{w}: frame {i} of a batch of {k} "
                  "differs from its flush alone")
        stack = torch.stack(frames)
        whr, whi = od.dft_matrix_factors(h, device=dev)
        wwr, wwi = od.dft_matrix_factors(w, device=dev)
        tr, ti = od.dft_stage1_batched(whr, whi, stack,
                                       dac_bits=spec.dac.bits)
        pr, pi = od.dft_stage1_batched_plain(whr, whi, stack,
                                             dac_bits=spec.dac.bits)
        got = od.dft_stage2_batched(tr, ti, wwr, wwi)
        want = od.dft_stage2_batched_plain(tr, ti, wwr, wwi)
        torch.cuda.synchronize()
        check(max(max_violation(tr, pr, 1e-4, 1e-5),
                  max_violation(ti, pi, 1e-4, 1e-5)) <= 0.0,
              f"stage 1 at ({k}, {h}, {h}, {w}) outside rtol 1e-4 / atol "
              "1e-5 of its plain version")
        check(max_violation(got, want, 2e-4, 2e-4 * float(want.max()))
              <= 0.0, f"stage 2 at ({k}, {h}, {w}, {w}) outside rtol 2e-4 / "
              "atol 2e-4*max of its plain version")
        adc = adc_quantize_batched(got, spec.adc.bits)
        check(all(torch.equal(adc[i], flushed[k][i]) for i in range(k)),
              f"{h}x{w}: the flush differs from the ADC of the kernels")
        errs[f"{h}x{w}"] = {
            "batch": k,
            "stage1_max_abs_err": max(float((tr - pr).abs().max()),
                                      float((ti - pi).abs().max())),
            "stage2_max_abs_err": float((got - want).abs().max())}
        print(f"  {h}x{w} x{k}: batched == looped == ADC(kernels) bit for "
              f"bit; stage 1 / 2 max |err| vs plain "
              f"{errs[f'{h}x{w}']['stage1_max_abs_err']:.3e} / "
              f"{errs[f'{h}x{w}']['stage2_max_abs_err']:.3e}")
    return errs


def run_example(module) -> tuple[dict, str]:
    """``module.main([])`` (the card, its default) with its output kept,
    and what the ``run`` it calls returned."""
    import contextlib
    import io
    got, real = {}, module.run

    def recording(device):
        got["result"] = real(device)
        return got["result"]
    out = io.StringIO()
    module.run = recording
    try:
        with contextlib.redirect_stdout(out):
            rc = module.main([])
    finally:
        module.run = real
    check(rc == 0 and "result" in got, f"{module.__name__}.main exited {rc}")
    return got["result"], out.getvalue()


def check_examples(rt, od, dev) -> dict:
    """Both examples' mains on the card, held to their invariants and
    the quickstart's physics to the CPU's on the same image."""
    from repro_torch.examples import optical_offload, quickstart

    od.reset_launches()
    qs, _ = run_example(quickstart)
    oo, text = run_example(optical_offload)
    routes = dft_routes(od)
    cpu = quickstart.physics(quickstart.image(), "cpu")
    for bits, err in qs["physics"]["fft_rel_err"].items():
        want = cpu["fft_rel_err"][bits]
        check(abs(err - want) <= 1e-5 * want, f"quickstart |FFT| error at "
              f"{bits} bits: card {err} vs cpu {want}")
    want = cpu["conv_rel_err"]
    check(abs(qs["physics"]["conv_rel_err"] - want) <= 5e-2 * want,
          f"quickstart conv error: card {qs['physics']['conv_rel_err']} vs "
          f"cpu {want}")
    plan, sh, tr = oo["plan"], oo["sharded"], oo["trickle"]
    check(not plan["prototype_offload"] and plan["fidelity_ok"],
          f"offload example plan: {plan}")
    enob = min(rt.BATCHED_4F.dac.effective_bits,
               rt.BATCHED_4F.adc.effective_bits)
    check(sh["rel_err"] <= rt.enob_error_bound(enob, 16.0)
          and sh["sharded_modeled_s"] < sh["single_modeled_s"],
          f"offload example sharded step: {sh}")
    check(tr["scheduler-held"]["occupancy"]
          > tr["drain-on-flush"]["occupancy"], f"trickle step: {tr}")
    tiles, tile_k = oo["tiled"]["dispatched_tile_sizes"], oo["tiled"]["tile_k"]
    check(max(tiles) <= tile_k
          and max(tiles) == min(tile_k, optical_offload.IMAGES)
          and sum(k * v for k, v in tiles.items()) == optical_offload.IMAGES,
          f"tiled step: {oo['tiled']}")
    ch, res = oo["chaos"], oo["residency"]
    check(ch["all_retired"] and ch["faults_total"] > 0
          and ch["worst_rel_err"] <= ch["enob_bound"], f"chaos step: {ch}")
    check(res["hit_dac_s"] == 0.0 and res["bit_equal"],
          f"residency step: {res}")
    for name, r in routes.items():
        check(r["tensor_core"] > 0 and r["fma"] == 0,
              f"the examples' {name} launches by route: {r}")
    print(f"  quickstart |FFT| error at 8/12/16 bits "
          f"{[round(e, 6) for e in qs['physics']['fft_rel_err'].values()]} "
          f"(cpu {[round(e, 6) for e in cpu['fft_rel_err'].values()]}), "
          f"conv {qs['physics']['conv_rel_err']:.3e}")
    print(f"  optical_offload: conv routed {plan['routes']['conv']}, "
          f"stack error {plan['stack_rel_err']:.4f}; sharded error "
          f"{sh['rel_err']:.4f}; tile_k {oo['tiled']['tile_k']} of a "
          f"{oo['tiled']['budget_bytes'] // (1 << 20)} MiB budget; chaos "
          f"worst {ch['worst_rel_err']:.2e}; {len(text.splitlines())} lines "
          f"printed; DFT launches by route {routes}")
    return {"quickstart": qs["physics"], "offload": oo, "launches": routes}


def phase_runtime_bench(rt, od, la, cb, dev, card: str) -> dict:
    """casestudy/runtime_bench.py's payload at the reference's sizes on
    the card, then the examples' mains."""
    from repro_torch.casestudy import runtime_bench as rb

    t0 = time.perf_counter()
    for reset in (od.reset_launches, la.reset_launches, cb.reset_launches):
        reset()
    payload, by_column = bench_by_column(rb, od, dev)
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    launches = {n: getattr(od, n).launches for n in DFT_STAGES}
    others = {"local_flash_attention": la.local_flash_attention.launches,
              "converter_boundary": cb.converter_boundary.launches}
    check(all(n > 0 for n in launches.values()),
          f"the bench did not launch the DFT kernels: {launches}")
    check(not any(others.values()),
          f"the bench launched a kernel off its path: {others}")
    for column, routes in by_column.items():
        for name, r in routes.items():
            check(r["fma"] == 0, f"{column}: {name} left the tensor-core "
                  f"route: {r}")
    print(f"  [{card}] bench {bench_s:.2f} s; DFT launches {launches}")
    for row in rb.run(payload):
        print(f"  {row}")
    check_bench_gates(payload)
    print("  asserted gates held: batched < looped at 128^2 x 16, sharded "
          "modeled <= single, trickle held > drain, tile chosen == "
          "dispatched, chaos rows retired within bound with faults, "
          "residency model and bit-equality, coverage > 0.5, plan == "
          "execution")
    gates = timing_gates(rb, payload)
    for g in gates:
        print(f"  timing gate {g['gate']}: value {g['value']}, bound "
              f"{g['bound']}: {'held' if g['held'] else 'not held'}"
              + (f" ({g['message']})" if "message" in g else ""))
    frames = check_bench_frames(rt, rb, od, dev)
    print("phase 10b: the examples")
    examples = check_examples(rt, od, dev)
    wall = time.perf_counter() - t0
    print(f"  [{card}] phase wall {wall:.2f} s (bench {bench_s:.2f} s)")
    return {"card": card, "payload": payload, "launches": launches,
            "launches_by_column": by_column, "timing_gates": gates,
            "frames": frames, "examples": examples, "bench_s": bench_s,
            "phase_wall_s": wall}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import adc_dac as cb
    from repro_torch.kernels import build
    from repro_torch.kernels import local_attention as la
    from repro_torch.kernels import ops
    from repro_torch.kernels import optical_dft as od
    import repro_torch.runtime as rt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    print("phase 1: build")
    print(f"  {card}")
    t0 = time.perf_counter()
    build.build_all()
    print(f"  nvcc build {time.perf_counter() - t0:.2f} s")
    for stem in ("optical_dft", "local_attention", "adc_dac"):
        print("  " + build.build_log(stem).strip().replace("\n", "\n  "))
    tc_build = ptxas_report(build.build_log("local_attention"), TC_KERNELS)
    for r in tc_build:
        print(f"  ptxas: {r['kernel']}<{r['d']}>: {r['registers']} registers, "
              f"{r['spill_bytes']} bytes spilled")
    check(sorted((r["kernel"], r["d"]) for r in tc_build) ==
          sorted((k, d) for k in TC_KERNELS for d in TC_HEAD_DIMS)
          and all(r["spill_bytes"] == 0 for r in tc_build),
          f"kernel 6's tensor-core kernels spill or are missing: {tc_build}")
    fma_build = ptxas_report(build.build_log("local_attention"),
                             FMA_KERNELS)
    spills = [r for r in fma_build if r["spill_bytes"]]
    print(f"  ptxas: kernel 6's FMA route, {len(fma_build)} instantiations "
          f"(3 kernels x 3 dtypes x 7 head-dim buckets and the wide "
          f"kernels past 256), registers "
          f"{min(r['registers'] for r in fma_build)}-"
          f"{max(r['registers'] for r in fma_build)}, spilling: "
          f"{[(r['entry'], r['spill_bytes']) for r in spills]}")
    check(len(fma_build) == 3 * 3 * 8,
          f"kernel 6's FMA kernels are missing: {len(fma_build)} built")
    dft_build = ptxas_report(build.build_log("optical_dft"), DFT_TC_KERNELS)
    for r in dft_build:
        print(f"  ptxas: {r['kernel']}: {r['registers']} registers, "
              f"{r['spill_bytes']} bytes spilled")
    check(sorted(r["kernel"] for r in dft_build) == sorted(DFT_TC_KERNELS)
          and all(r["spill_bytes"] == 0 for r in dft_build),
          f"the DFT tensor-core kernels spill or are missing: {dft_build}")
    cb_build = ptxas_report(build.build_log("adc_dac"), BOUNDARY_KERNELS)
    for r in cb_build:
        print(f"  ptxas: {r['entry']}: {r['registers']} registers, "
              f"{r['spill_bytes']} bytes spilled")
    # 4 (x, noise) dtype pairs of the resident and stream kernels, 2 x
    # dtypes of the max kernel
    check(len(cb_build) == 10 and all(r["spill_bytes"] == 0
                                      for r in cb_build),
          f"kernel 5's kernels spill or are missing: {cb_build}")

    budget = rt.MemoryBudget.detect(dev)
    tile_k = budget.tile_for_group(SIDE * SIDE, SIDE * SIDE, FRAMES,
                                   pipeline_depth=2)
    print("phase 2: kernels against their plain versions")
    errs = phase_kernels(od, dev, tile_k)

    print("phase 3: main path")
    main_run = phase_main_path(rt, od, dev)
    phase_conv_stack(rt, dev)

    print("phase 4: times")
    rows = phase_times(od, dev, main_run, errs)

    print("phase 5: serving path")
    serving = phase_serving(rt, od, la, dev)
    attn_err = check_attention(la, dev, PROMPT_LENS)
    attn_row = attention_times(la, dev, serving, attn_err)

    print("phase 6: training path")
    training = phase_training(la, dev, card)
    bwd_err = check_attention_backward(la, dev)
    at_train, bwd_row = attention_train_times(la, dev, training, bwd_err,
                                              card)
    for row in rows[:2]:   # the DFT stages: offload flush, serving aux hook
        row["launches_by_path"] = {
            "offload": row["launches"],
            "serving": serving["launches"][row["name"]]}
    attn_row["launches_by_path"] = {
        "serving": serving["launches"]["local_flash_attention"],
        "training": training["launches"]["local_flash_attention"]}
    attn_row["launches"] = sum(attn_row["launches_by_path"].values())
    attn_row["at_training"] = at_train
    rows += [attn_row, bwd_row]

    print("phase 7: converter boundary")
    rows.append(phase_boundary(cb, ops, dev, card))

    print("phase 8: sharded runtime")
    sharded = phase_sharded(rt, od, dev, main_run, card)
    for row in rows[:2]:
        row["launches_by_path"]["sharded"] = \
            sharded["flush"]["launches"][row["name"]]
    print("phase 9: the paper's case study")
    casestudy = phase_casestudy(od, la, dev, card)
    print("phase 10: the runtime bench and the examples")
    bench = phase_runtime_bench(rt, od, la, cb, dev, card)
    for row in rows[:2]:
        row["launches_by_path"]["runtime_bench"] = bench["launches"][
            row["name"]]
        row["launches_by_path"]["examples"] = sum(
            bench["examples"]["launches"][row["name"]].values())
    print("phase 11: dense serving at full width")
    dense = phase_dense_serving(rt, od, la, dev, card)
    for row in rows[:2]:
        row["launches_by_path"]["dense_serving"] = sum(
            run["launches"][row["name"]] for run in dense.values())
    # kernel 6 beyond the main path: D 256 (recurrentgemma's local
    # attention, 16 heads on 1 KV head, window 2048) forward and backward
    attn_row["at_d256"] = attention_case(la, dev, 16, 1, PREFILL_L, 256,
                                         window=2048, backward=True)
    for arch, name in (("qwen2.5-32b", "local_flash_attention_d128_gqa5"),
                       ("nemotron-4-340b",
                        "local_flash_attention_d192_gqa12")):
        k6 = dense[arch]["kernel6"]
        rows.append({"name": name, "route": "cuda", "source": ATTN_SOURCE,
                     "replaces": REPLACES["local_flash_attention"],
                     "launches": dense[arch]["launches"][
                         "local_flash_attention"],
                     **{key: k6[key] for key in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "shape", "dtype",
                         "kernel_route", "backward")},
                     "path": f"phase 11 serving {arch}"})
    print("phase 12: the recurrent families")
    print("phase 12a: recurrentgemma-9b serving at full width")
    rg = phase_recurrent_serving(rt, od, la, dev, card)
    for row in rows[:2]:
        row["launches_by_path"]["recurrent_serving"] = rg["launches"][
            row["name"]]
    k6 = rg["kernel6"]
    rows.append({"name": "local_flash_attention_d256_window2048",
                 "route": "cuda", "source": ATTN_SOURCE,
                 "replaces": REPLACES["local_flash_attention"],
                 "launches": rg["launches"]["local_flash_attention"],
                 **{key: k6[key] for key in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms", "library_backend",
                     "library_mask", "library_kernels", "shape", "dtype",
                     "window", "kernel_route")},
                 "path": f"phase 12a serving {RG_ARCH}"})
    print("phase 12b: xlstm-125m training at full width")
    xl = phase_recurrent_training(dev, card)
    print("phase 12c: Adafactor and int8 error feedback")
    optim = phase_optimizers(dev, card)
    print("phase 12d: kernel 6 past head dim 256")
    attn_row["wide_head_dims"] = phase_wide_head_dims(la, dev, card)
    print("phase 13: MoE serving at full width")
    moe_runs = phase_moe_serving(rt, od, la, dev, card)
    for row in rows[:2]:
        row["launches_by_path"]["moe_serving"] = sum(
            moe_runs[arch]["launches"][row["name"]]
            for arch, _ in MOE_SERVING)
    for arch, name in (("qwen2-moe-a2.7b", "local_flash_attention_d128_mha16"),
                       ("deepseek-v3-671b",
                        "local_flash_attention_mla_d192_dv128")):
        k6 = moe_runs[arch]["kernel6"]
        rows.append({"name": name, "route": "cuda", "source": ATTN_SOURCE,
                     "replaces": REPLACES["local_flash_attention"],
                     "launches": moe_runs[arch]["launches"][
                         "local_flash_attention"],
                     **{key: k6[key] for key in (
                         "max_abs_err", "ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms", "library_backend",
                         "shape", "dv", "dtype", "kernel_route",
                         "backward")},
                     "path": f"phase 13 serving {arch}"})
    print("phase 14: the encoder-decoder and vision families")
    mm = phase_multimodal(la, dev, card)
    for arch, section in ((ENCDEC_ARCH, "kernel6"),
                          (ENCDEC_ARCH, "kernel6_backward"),
                          (VISION_ARCH, "kernel6")):
        backward = section == "kernel6_backward"
        for name, k6 in mm[arch][section].items():
            nums = k6["backward"] if backward else k6
            row = {"name": name, "route": "cuda", "source": ATTN_SOURCE,
                   "replaces": REPLACES["local_flash_attention_backward"
                                        if backward
                                        else "local_flash_attention"],
                   "launches": k6["launches"],
                   **{k: nums[k] for k in (
                       "max_abs_err", "ms", "plain_ms", "bound_ms",
                       "bound_by", "library_ms")},
                   **{k: k6[k] for k in (
                       "shape", "lk", "dtype", "causal", "kernel_route",
                       "shape_key")},
                   "path": f"phase 14 {arch} "
                           f"{'gradient step' if backward else 'serving'}"}
            if backward:
                row["forward"] = {k: k6[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library_backend")}
            else:
                row["library_backend"] = k6["library_backend"]
            rows.append(row)
    print("phase 15: the mesh and the dry run")
    t0 = time.perf_counter()
    meshed = phase_mesh(la, dev, card, training)
    dryrun = phase_dryrun(card)
    print(f"  [{card}] phase wall {time.perf_counter() - t0:.2f} s")
    print("phase 16: the mesh's serving and the roofline against the card")
    t0 = time.perf_counter()
    print("phase 16a: MoE serving on the mesh")
    mesh_moe = phase_mesh_serving(la, dev, card,
                                  moe_runs[MESH_MOE_ARCH]["kernel6"])
    print("phase 16c: one-card roofline rows against the card")
    roof = card_roofline(training, serving, card)
    print(f"  [{card}] phase wall {time.perf_counter() - t0:.2f} s")
    print("phase 17: training the MoE, MLA and hybrid families")
    t0 = time.perf_counter()
    families = phase_family_training(la, dev, card)
    print(f"  [{card}] phase wall {time.perf_counter() - t0:.2f} s")
    for arch, run in families.items():
        for name, k6 in run["kernel6_backward"].items():
            rows.append({
                "name": name, "route": "cuda", "source": ATTN_SOURCE,
                "replaces": REPLACES["local_flash_attention_backward"],
                "launches": k6["launches"],
                **{k: k6["backward"][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                **{k: k6[k] for k in ("shape", "lk", "dv", "dtype", "causal",
                                      "window", "kernel_route", "shape_key",
                                      "library_backend", "library_mask")},
                "forward": {k: k6[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                "forward_launches": run["forward_launches"]["tensor_core"],
                "path": f"phase 17 training {arch}"})
    attn_row["launches_by_path"]["meshed_training"] = \
        meshed["launches"]["forward"]
    attn_row["launches_by_path"]["meshed_serving"] = \
        mesh_moe["launches"]["forward"]
    attn_row["launches_by_path"]["family_training"] = sum(
        run["forward_launches"]["tensor_core"] for run in families.values())
    attn_row["launches"] = sum(attn_row["launches_by_path"].values())
    attn_row["at_meshed_training"] = meshed["kernel6"]
    attn_row["at_meshed_serving"] = mesh_moe["kernel6"]
    bwd_row["launches_by_path"] = {
        "training": bwd_row["launches"],
        "meshed_training": meshed["launches"]["backward"],
        "family_training": sum(run["backward_launches"]["tensor_core"]
                               for run in families.values())}
    bwd_row["launches"] = sum(bwd_row["launches_by_path"].values())
    print(json.dumps({"main_path": main_run}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": training}))
    print(json.dumps({"casestudy": casestudy}))
    print(json.dumps({"runtime_bench": bench}, default=str))
    print(json.dumps({"dense_serving": dense}))
    print(json.dumps({"recurrent": {"serving": rg, "training": xl,
                                    "optimizers": optim}}))
    print(json.dumps({"moe_serving": moe_runs}))
    print(json.dumps({"multimodal": mm}))
    print(json.dumps({"mesh": meshed, "dryrun": dryrun}))
    print(json.dumps({"mesh_serving": mesh_moe, "card_roofline": roof}))
    print(json.dumps({"family_training": families}))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
