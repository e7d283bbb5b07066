"""Model configuration — one dataclass covering all assigned arch families.

Families: dense decoder LMs (GQA), MoE (shared+routed top-k), MLA+MoE
(DeepSeek-V3), hybrid recurrent (RG-LRU + local attention), xLSTM
(sLSTM/mLSTM), encoder-decoder (Seamless), and VLM/audio-frontend stubs.
The dataclasses are the reference's, field for field, so a config built
for either package describes the same model; the port's model code runs
the dense and recurrent families so far (``ROADMAP.md`` lists the rest).

Layer stacking: each layer has a *kind* (``attn``, ``moe``, ``rglru``,
``mlstm``, ``slstm``), laid out as ``prefix + repeated pattern
super-blocks + tail``.  Parameters of the repeated super-blocks are
stacked on a leading layer axis, as in the reference; the port walks that
axis with a Python loop.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

__all__ = ["MoEConfig", "MLAConfig", "ModelConfig", "LayerPlan",
           "torch_dtype"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` a config's dtype name stands for."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int
    top_k: int
    d_expert: int                 # intermediate size of each routed expert
    n_shared: int = 0
    d_shared: int | None = None   # intermediate size of each shared expert
    router_noise: float = 0.0
    aux_loss_coef: float = 0.001
    # "ep"  -> experts sharded over the model axis (one expert group/chip)
    # "tp"  -> every expert's ffn dim sharded over the model axis
    shard_mode: str = "ep"
    # tokens per expert = ceil(S * top_k * capacity_factor / n_routed);
    # overflow tokens fall through the residual (standard dropped-token MoE)
    capacity_factor: float = 1.25

    @property
    def d_shared_total(self) -> int:
        return (self.d_shared or self.d_expert) * self.n_shared


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def cache_dim(self) -> int:
        """Per-token decode cache: compressed kv + shared rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # audio|dense|hybrid|vlm|moe|ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # layer stack: kinds cycled from ``pattern``; ``dense_prefix`` forces the
    # first k layers to plain attn+dense-mlp (DeepSeek-V3's first 3 layers).
    pattern: tuple[str, ...] = ("attn",)
    dense_prefix: int = 0
    # attention
    attn_bias: bool = False
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0         # stablelm-2 uses 25% partial rotary
    local_window: int = 0         # >0: sliding-window for ``attn`` layers
    mla: MLAConfig | None = None
    # mlp
    mlp_kind: str = "swiglu"      # swiglu|relu2|geglu|none
    moe: MoEConfig | None = None
    # recurrent families
    lru_width: int | None = None  # RG-LRU state width (default d_model)
    conv1d_width: int = 4
    # encoder-decoder
    encoder_layers: int = 0
    # frontends (stubs: input_specs provide precomputed embeddings)
    frontend: str | None = None   # audio|vision|None
    frontend_tokens: int = 0      # e.g. 576 vision patches
    # numerics
    dtype: str = "bfloat16"       # activations
    param_dtype: str = "float32"  # parameters (bf16 + Adafactor for >=30B)
    norm_eps: float = 1.0e-6
    tie_embeddings: bool = False
    logit_chunks: int = 8         # chunked CE to bound the logits peak
    vocab_pad_multiple: int = 2048  # pad tables so "model"-axis sharding divides

    # ----- derived -------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def tokens_only(self) -> bool:
        """The model takes token prompts alone: no encoder frames, no
        vision patches."""
        return not self.is_encdec and self.frontend is None

    def layer_kinds(self) -> tuple[str, ...]:
        kinds = ["attn"] * self.dense_prefix
        i = 0
        while len(kinds) < self.n_layers:
            kinds.append(self.pattern[i % len(self.pattern)])
            i += 1
        return tuple(kinds[: self.n_layers])

    def layer_plan(self) -> "LayerPlan":
        return LayerPlan.build(self.layer_kinds(), self.pattern, self.dense_prefix)

    def uses_moe_at(self, layer_idx: int) -> bool:
        return self.moe is not None and layer_idx >= self.dense_prefix

    # Parameter counts are computed from the actual template tree — see
    # ``repro_torch.models.params.param_counts`` — so they can never drift from
    # the implementation.


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """How the layer list compiles to prefix + scanned super-blocks + tail."""

    prefix: tuple[str, ...]        # unrolled leading layer kinds
    super_block: tuple[str, ...]   # one scanned repetition
    n_super: int                   # scan length
    tail: tuple[str, ...]          # unrolled trailing layer kinds

    @staticmethod
    def build(kinds: Sequence[str], pattern: Sequence[str],
              dense_prefix: int) -> "LayerPlan":
        prefix = tuple(kinds[:dense_prefix])
        body = tuple(kinds[dense_prefix:])
        plen = len(pattern)
        n_super = len(body) // plen
        tail = body[n_super * plen:]
        return LayerPlan(prefix=prefix, super_block=tuple(pattern),
                         n_super=n_super, tail=tail)

    @property
    def n_layers(self) -> int:
        return len(self.prefix) + self.n_super * len(self.super_block) + len(self.tail)
