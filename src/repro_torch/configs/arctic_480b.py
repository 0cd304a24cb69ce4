"""arctic-480b — MoE 128e top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf] (copy of
``repro/configs/arctic_480b.py``)"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoEConfig(n_experts=128, top_k=2, expert_d_ff=4864, moe_every=1,
                  dense_residual_d_ff=4864, ep_mode="subgrid", f_sub=2),
    notes="dense-FFN residual branch in parallel with 128e top-2 MoE",
    source="hf:Snowflake/snowflake-arctic-base",
)
