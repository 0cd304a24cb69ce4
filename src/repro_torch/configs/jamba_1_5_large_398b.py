"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE 16e top-2. [arXiv:2403.19887; hf]

A copy of ``repro/configs/jamba_1_5_large_398b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, HybridConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(n_experts=16, top_k=2, expert_d_ff=24576, moe_every=2,
                  moe_offset=1, ep_mode="grid"),
    ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2, chunk=256),
    hybrid=HybridConfig(period=8, attn_index=4),
    notes="period-8 blocks (attn at index 4, 7 mamba); MoE every 2nd layer; sub-quadratic-dominant (runs long_500k)",
    source="arXiv:2403.19887",
)
