"""stablelm-1.6b [dense]: 24L d_model=2048 32H (kv=32 => MHA) d_ff=5632
vocab=100352 — 25% partial rotary [hf:stabilityai/stablelm-2-1_6b]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab_size=100352, rope_pct=0.25, mlp_kind="swiglu",
    param_dtype="float32", logit_chunks=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=500, vocab_pad_multiple=64, logit_chunks=2,
)
