"""Architecture registry.

``get_config(arch)`` / ``get_smoke_config(arch)`` return the full and
reduced configs of an architecture the port runs.  ``ARCHS`` names every
architecture of the reference; one whose model code the port does not
have yet raises ``NotImplementedError`` (``ROADMAP.md`` lists the order in
which they come).  The shape table (``SHAPES``, ``Shape``,
``applicable``, ``applicable_shapes``) is the reference's; ``input_specs``
waits for the dry run's port.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.shapes import (SHAPES, Shape, applicable,
                                        applicable_shapes)
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "PORTED", "get_config", "get_smoke_config", "SHAPES",
           "Shape", "applicable", "applicable_shapes"]

ARCHS: dict[str, str] = {
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-72b": "qwen2_72b",
    "qwen2.5-32b": "qwen2_5_32b",
    "stablelm-1.6b": "stablelm_1_6b",
    "nemotron-4-340b": "nemotron_4_340b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llava-next-34b": "llava_next_34b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "xlstm-125m": "xlstm_125m",
}

# architectures whose configs and model code the port has
PORTED: tuple[str, ...] = ("qwen2-72b", "qwen2.5-32b", "stablelm-1.6b",
                           "nemotron-4-340b", "recurrentgemma-9b",
                           "qwen2-moe-a2.7b", "deepseek-v3-671b",
                           "xlstm-125m")


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch!r} is not ported yet (ported: {', '.join(PORTED)}); "
            "see ROADMAP.md")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
