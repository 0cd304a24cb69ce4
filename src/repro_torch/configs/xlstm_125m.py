"""xlstm-125m — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

d_ff=0 per the assignment: blocks use their own up-projection (proj_factor 2).
One sLSTM block per 4 (rest mLSTM) — documented simplification of the paper's
[7:1] mixing.

A copy of ``repro/configs/xlstm_125m.py``."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm=SSMConfig(kind="xlstm", slstm_every=4, proj_factor=2.0, chunk=256),
    notes="sLSTM + mLSTM blocks; sub-quadratic (runs long_500k)",
    source="arXiv:2405.04517",
)
