"""The paper's decision rule applied to the LM architectures the port runs.

The twin of the reference's ``benchmarks/planner_table.py``.  For each
of the ten architectures (``configs.ARCHS``: dense, recurrent, MoE,
encoder-decoder and vision):

  1. count the FLOPs of one smoke-config ``LM.loss`` at 2 x 32 tokens
     (plus 16 encoder frames for the encoder-decoder, and the frontend's
     patches before the tokens for the vision model, as the reference
     builds its batch), by category {matmul, conv, fft, other}, with
     ``core.profiler.flops_by_category`` on the ``meta`` device (shapes
     only: nothing is computed, and the counts are those of any device);
  2. turn each category's FLOPs into host seconds at ``HOST_PEAK``, the
     H100's dense bf16 rate (the reference prices at a TPU v5e's
     197e12): the most generous host model, since any real host
     inefficiency only helps the accelerator;
  3. price offloading matmul on the optical MVM accelerator
     (``ANDERSON_MVM``: honest on-frontier converters) and conv/fft on the
     ideal 4f accelerator (``IDEAL_4F``), DAC/ADC and interface included,
     with the reference's sample accounting;
  4. report the Amdahl-bounded end-to-end speedup and the verdict against
     the 10x build threshold (the paper's section 5).

The matmul, conv and fft counts are the reference's exactly; 'other' is an
approximate count by design, and the port's is about half the
reference's (``core/profiler.py``: views count nothing here), so a row's
'other' share and the Amdahl bound it sets differ from the reference's.
"""

from __future__ import annotations

import torch

from repro_torch import configs as cfgs
from repro_torch.core.accelerator import ANDERSON_MVM, IDEAL_4F
from repro_torch.core.planner import CategoryProfile, plan_offload
from repro_torch.casestudy.roofline import PEAK_FLOPS
from repro_torch.core.profiler import flops_by_category
from repro_torch.models import LM
from repro_torch.models.config import torch_dtype
from repro_torch.models.params import map_tree, model_templates

__all__ = ["HOST_PEAK", "run", "arch_row"]

HOST_PEAK = PEAK_FLOPS  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
_BATCH, _SEQ = 2, 32


def _arch_profile(arch: str) -> tuple[dict, int]:
    """(FLOPs by category, tokens) of the smoke config's loss on meta."""
    cfg = cfgs.get_smoke_config(arch)
    model = LM(cfg)
    params = map_tree(lambda s: torch.empty(
        s.shape, dtype=torch_dtype(s.dtype or cfg.param_dtype),
        device="meta"), model_templates(cfg))
    tokens = torch.zeros((_BATCH, _SEQ), dtype=torch.long, device="meta")
    batch = {"tokens": tokens, "labels": tokens}
    if cfg.is_encdec:
        batch["frames"] = torch.empty((_BATCH, _SEQ // 2, cfg.d_model),
                                      dtype=cfg.activation_dtype,
                                      device="meta")
    if cfg.frontend == "vision":
        batch["patches"] = torch.empty(
            (_BATCH, cfg.frontend_tokens, cfg.d_model),
            dtype=cfg.activation_dtype, device="meta")
    cats = flops_by_category(lambda p, b: model.loss(p, b)[0], params,
                             batch)
    return cats, _BATCH * _SEQ


def arch_row(arch: str, flops: dict, tokens: int) -> dict:
    """The table's row of ``arch`` from its FLOPs by category."""
    total = sum(flops.values())
    d = cfgs.get_smoke_config(arch).d_model
    profiles = []
    for cat in ("matmul", "conv", "fft", "other"):
        fl = flops.get(cat, 0.0)
        if fl <= 0:
            continue
        # activations out = flops / (2 K) with K ~ d_model; in = 2x out
        samples = int(fl / max(2 * d, 1))
        profiles.append(CategoryProfile(
            name=cat, host_s=fl / HOST_PEAK, calls=max(tokens, 1),
            samples_in=2 * samples, samples_out=samples))
    plan_mvm = plan_offload(profiles, ANDERSON_MVM)
    plan_4f = plan_offload(profiles, IDEAL_4F)
    return {
        "arch": arch,
        "flops_pct": {k: 100 * v / total for k, v in sorted(flops.items())},
        "mvm_speedup": plan_mvm.end_to_end_speedup,
        "mvm_worthwhile": plan_mvm.worthwhile,
        "mvm_conversion_bound": plan_mvm.conversion_bound,
        "fourier_speedup": plan_4f.end_to_end_speedup,
        "fourier_worthwhile": plan_4f.worthwhile,
    }


def run() -> list[dict]:
    """One row per architecture, in ``configs.ARCHS``' order."""
    return [arch_row(arch, *_arch_profile(arch)) for arch in cfgs.ARCHS]
