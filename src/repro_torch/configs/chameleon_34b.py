"""chameleon-34b — early-fusion VLM; VQ image tokens. [arXiv:2405.09818; unverified]

Early fusion means image patches arrive as VQ codes inside the ordinary token
vocabulary (65536 covers text + image codes); the VQ tokenizer frontend is a
stub: the model takes token ids.

(Copy of ``repro/configs/chameleon_34b.py``.)
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    notes="early-fusion VLM; VQ image tokens = ordinary ids (frontend stubbed)",
    source="arXiv:2405.09818",
)
