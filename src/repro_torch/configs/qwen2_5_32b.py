"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA, QKV bias [hf:Qwen/Qwen2.5-*; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=27648,
    vocab_size=152064, attn_bias=True, rope_theta=1e6,
    mlp_kind="swiglu", param_dtype="bfloat16", logit_chunks=16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, d_model=80, n_heads=5, n_kv_heads=1, d_ff=192,
    vocab_size=512, vocab_pad_multiple=64, param_dtype="float32",
    logit_chunks=2,
)
