"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000 — squared-ReLU MLP (2 matrices, ungated) [arXiv:2402.16819]."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
    vocab_size=256000, mlp_kind="relu2",
    param_dtype="bfloat16", logit_chunks=16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=96, n_heads=6, n_kv_heads=2, d_ff=256,
    vocab_size=512, vocab_pad_multiple=64, param_dtype="float32",
    logit_chunks=2,
)
