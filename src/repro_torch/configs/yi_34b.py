"""yi-34b — llama-arch GQA. [arXiv:2403.04652; hf] (copy of
``repro/configs/yi_34b.py``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    notes="llama-arch GQA",
    source="arXiv:2403.04652",
)
