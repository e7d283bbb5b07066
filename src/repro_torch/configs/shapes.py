"""Assigned input shapes and their applicability rules.

Every LM arch is paired with four shapes; ``decode_*`` / ``long_*`` lower
``serve``/``decode_step`` (one token against a seq_len cache), not
``train_step``.  ``long_500k`` requires sub-quadratic sequence mixing and
is skipped for the eight full-attention archs (incl. DeepSeek-V3 — MLA
compresses the cache but attention is still O(L^2)); it runs for the
hybrid (RG-LRU + local attention) and xLSTM families.  No assigned arch is
encoder-only, so decode shapes run everywhere.

A copy of the reference's ``configs/shapes.py`` (pure Python).
``configs.input_specs`` turns a (config, shape) cell into the step's
input stand-ins.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Shape", "SHAPES", "applicable", "applicable_shapes"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

# families whose sequence mixing is sub-quadratic end to end
_SUBQUADRATIC_FAMILIES = ("hybrid", "ssm")


def applicable(family: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return family in _SUBQUADRATIC_FAMILIES
    return True


def applicable_shapes(family: str) -> list[str]:
    return [s for s in SHAPES if applicable(family, s)]
