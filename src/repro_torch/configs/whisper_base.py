"""whisper-base — enc-dec, conv frontend STUB. [arXiv:2212.04356; unverified]

The assignment specifies the transformer backbone only; ``input_specs()`` feeds
precomputed frame embeddings (B, S, d_model) in place of the conv frontend.

A copy of ``repro/configs/whisper_base.py``."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,          # decoder layers
    n_enc_layers=6,      # encoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    dec_len_ratio=8,
    input_kind="frames",
    notes="enc-dec; conv frontend stubbed with precomputed frame embeddings",
    source="arXiv:2212.04356",
)
