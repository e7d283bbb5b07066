"""qwen2-moe-a2.7b [moe]: 24L d_model=2048 16H (MHA kv=16) vocab=151936,
60 routed experts top-4 + 4 shared, expert d_ff=1408
[hf:Qwen/Qwen1.5-MoE-A2.7B].

``shard_mode="tp"`` is the reference's choice for its 16-chip model axis
(60 experts do not divide 16, so each expert's ffn dim would be split);
the port runs on one card and keeps the field so that the configs stay
equal field for field."""
import dataclasses
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=5632,
    vocab_size=151936, attn_bias=True, rope_theta=1e6,
    moe=MoEConfig(n_routed=60, top_k=4, d_expert=1408, n_shared=4,
                  d_shared=1408, shard_mode="tp"),
    param_dtype="bfloat16", logit_chunks=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
    vocab_size=500, vocab_pad_multiple=64, param_dtype="float32",
    logit_chunks=2,
    moe=MoEConfig(n_routed=8, top_k=2, d_expert=32, n_shared=2,
                  d_shared=32, shard_mode="tp"),
)
