"""qwen1.5-32b — MHA (kv=40), QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf] (copy of
``repro/configs/qwen1_5_32b.py``)"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    notes="QKV bias, full MHA",
    source="hf:Qwen/Qwen1.5-0.5B",
)
