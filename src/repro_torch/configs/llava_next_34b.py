"""llava-next-34b [vlm]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000 — anyres tiling frontend is a STUB: ``input_specs`` provides
576 precomputed patch embeddings prepended to the token sequence
[hf:llava-hf/llava-v1.6-*]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, rope_theta=5e6, frontend="vision", frontend_tokens=576,
    mlp_kind="swiglu", param_dtype="bfloat16", logit_chunks=16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
    frontend_tokens=4, vocab_size=500, vocab_pad_multiple=64,
    param_dtype="float32", logit_chunks=2,
)
