"""deepseek-v3-671b [moe]: 61L d_model=7168, MLA (128 heads, kv_rank=512,
rope=64), 256 routed experts top-8 + 1 shared (expert d_ff=2048), first 3
layers dense (d_ff=18432), vocab=129280 [arXiv:2412.19437].

MTP (multi-token prediction) is a training-objective add-on and is not
implemented, as in the reference.  ``shard_mode="ep"`` is the reference's
expert sharding (256 = 16 x 16); the port runs on one card and keeps the
field so that the configs stay equal field for field."""
import dataclasses
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, d_ff=18432,
    vocab_size=129280, dense_prefix=3,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=256, top_k=8, d_expert=2048, n_shared=1,
                  d_shared=2048, shard_mode="ep"),
    param_dtype="bfloat16", logit_chunks=16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=3, dense_prefix=1, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=500, vocab_pad_multiple=64, param_dtype="float32",
    logit_chunks=2,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=8,
                  qk_rope_head_dim=4, v_head_dim=8),
    moe=MoEConfig(n_routed=8, top_k=2, d_expert=32, n_shared=1,
                  d_shared=32, shard_mode="ep"),
)
