"""Architecture registry + input specs.

``get_config(arch)`` / ``get_smoke_config(arch)`` return the full and
reduced configs of any architecture of the reference (``ARCHS``; the
port runs all ten).  ``input_specs(cfg, shape)`` returns
``meta``-device stand-ins for every model input of a (config, shape)
cell, the reference's shapes and dtypes with no memory behind them.  The
shape table (``SHAPES``, ``Shape``, ``applicable``,
``applicable_shapes``) is the reference's.  ``TOKEN_ARCHS`` are the
architectures whose model takes token prompts alone
(``ModelConfig.tokens_only``): the serving engine and the training CLI's
``MarkovTask`` feed nothing else, so the encoder-decoder and vision
archs run through ``LM`` directly.
"""

from __future__ import annotations

import importlib

import torch

from repro_torch.configs.shapes import (SHAPES, Shape, applicable,
                                        applicable_shapes)
from repro_torch.models.config import ModelConfig

__all__ = ["ARCHS", "TOKEN_ARCHS", "get_config",
           "get_smoke_config", "input_specs", "SHAPES", "Shape",
           "applicable", "applicable_shapes"]

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


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


TOKEN_ARCHS: tuple[str, ...] = tuple(
    a for a in ARCHS if get_config(a).tokens_only)


def input_specs(cfg: ModelConfig, shape: str | Shape,
                *, with_labels: bool | None = None) -> dict:
    """``meta`` tensors standing in for one (arch x shape) cell's step
    inputs, the reference's ``input_specs`` (shapes and dtypes) with
    int64 tokens and labels, the port's token dtype (the reference's are
    int32).

    train  -> the ``loss``/train-step batch;
    prefill-> the prefill batch (no labels);
    decode -> the one-token batch (the cache comes from
              ``LM.init_cache(..., device="meta")``, not from here).
    """
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    b, s = sh.global_batch, sh.seq_len
    act = cfg.activation_dtype

    def spec(shape_, dtype=torch.int64):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if sh.kind == "decode":
        return {"tokens": spec((b, 1))}
    labels = sh.kind == "train" if with_labels is None else with_labels
    out: dict = {}
    if cfg.is_encdec:
        out["frames"] = spec((b, s // 2, cfg.d_model), act)
        out["tokens"] = spec((b, s))
        if labels:
            out["labels"] = spec((b, s))
        return out
    s_text = s - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    out["tokens"] = spec((b, s_text))
    if cfg.frontend == "vision":
        out["patches"] = spec((b, cfg.frontend_tokens, cfg.d_model), act)
    if labels:
        out["labels"] = spec((b, s_text))
    return out
