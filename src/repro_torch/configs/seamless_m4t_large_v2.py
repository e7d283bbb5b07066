"""seamless-m4t-large-v2 [audio]: enc-dec multimodal backbone.

24 encoder + 24 decoder layers, d_model=1024, 16 heads (kv=16 => MHA),
d_ff=8192, vocab=256206 [arXiv:2308.11596; hf].  The audio frontend is a
STUB: ``input_specs`` provides precomputed frame embeddings at d_model;
only a linear adapter is learned in-repo.  As in the reference's config,
RoPE + gated MLP replace the original sinusoidal positions + plain ReLU
FFN (backbone dims are exact).
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab_size=256206, encoder_layers=24, frontend="audio",
    mlp_kind="swiglu", param_dtype="float32", logit_chunks=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, encoder_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=503, vocab_pad_multiple=64, logit_chunks=2,
)
