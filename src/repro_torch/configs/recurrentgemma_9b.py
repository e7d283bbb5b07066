"""recurrentgemma-9b [hybrid]: 38L RG-LRU + local attention in a 2:1
pattern, d_model=4096, 16H MQA (kv=1), d_ff=12288, vocab=256000,
window=2048, lru_width=4096 [arXiv:2402.19427].

38 = 12 x (rglru, rglru, attn) + 2 trailing rglru layers; the framework
scans the 12 super-blocks and unrolls the 2-layer tail."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab_size=256000, pattern=("rglru", "rglru", "attn"),
    local_window=2048, lru_width=4096, mlp_kind="geglu",
    param_dtype="bfloat16", logit_chunks=16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=5, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
    lru_width=64, local_window=8, vocab_size=500, vocab_pad_multiple=64,
    param_dtype="float32", logit_chunks=2,
)
