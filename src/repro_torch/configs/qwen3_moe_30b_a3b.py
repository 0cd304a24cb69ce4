"""qwen3-moe-30b-a3b — MoE 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]
(copy of ``repro/configs/qwen3_moe_30b_a3b.py``)"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,            # per-expert FFN width
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=768, moe_every=1),
    rope_theta=1_000_000.0,
    notes="128 experts top-8, every layer MoE",
    source="hf:Qwen/Qwen3-30B-A3B",
)
