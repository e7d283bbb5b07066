"""qwen2-72b [dense]: 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064 — GQA with QKV bias [arXiv:2407.10671; hf]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, attn_bias=True, rope_theta=1e6,
    mlp_kind="swiglu", param_dtype="bfloat16", logit_chunks=16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=1, d_ff=160,
    vocab_size=511, vocab_pad_multiple=64, param_dtype="float32",
    logit_chunks=2,
)
