"""xlstm-125m [ssm]: 12L d_model=768 4H vocab=50304 — mLSTM (matrix
memory) + sLSTM (scalar memory) blocks [arXiv:2405.04517].

Block ratio: (5 mLSTM : 1 sLSTM) x 2 approximates the paper's 7:1 at this
depth.  d_ff=0 per the brief: mLSTM blocks carry their own pf=2
up/down-projection; sLSTM blocks a pf-4/3 gated FFN.  125M-class: inner
matrices replicate (DP-only), only vocab tables shard (DESIGN.md §6)."""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab_size=50304, mlp_kind="none",
    pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    param_dtype="float32", logit_chunks=8,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=4, d_model=64, n_heads=2, n_kv_heads=2,
    pattern=("mlstm", "slstm"), vocab_size=500, vocab_pad_multiple=64,
    logit_chunks=2,
)
