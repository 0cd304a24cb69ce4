"""Reduced configs: same family/topology, tiny dims — for CPU smoke tests
(copy of ``repro/configs/reduce.py``).

Dims are kept divisible by 4 on every shardable axis so the same reduced
configs also drive the small-mesh (2x2 / 4x2) shard_map equivalence tests.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (HybridConfig, MLAConfig, ModelConfig,
                                      MoEConfig, SSMConfig)


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    if cfg.family == "small":
        return cfg
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=128,
        vocab_size=512,
        head_dim=16,
    )
    if cfg.attn_type == "mla":
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=8, qk_rope_head_dim=8,
                              v_head_dim=8)
        kw["head_dim"] = 0
    if cfg.moe is not None:
        # subgrid packing must tile the (2 x 2) test mesh: E * f_sub = 4
        n_exp = 2 if cfg.moe.ep_mode == "subgrid" else 8
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=n_exp, top_k=2, expert_d_ff=32,
            dense_residual_d_ff=32 if cfg.moe.dense_residual_d_ff else 0,
            capacity_factor=2.0)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=4, d_conv=4, chunk=32,
            slstm_every=2, dt_rank=8)
        if cfg.family == "ssm":
            kw["d_ff"] = 0
            kw["n_layers"] = 2       # one period of 2 (1 mLSTM + 1 sLSTM)
    if cfg.family == "hybrid":
        kw["hybrid"] = HybridConfig(period=4, attn_index=2)
        kw["n_layers"] = 4
        kw["moe"] = dataclasses.replace(kw["moe"], moe_every=2, moe_offset=1)
    if cfg.family == "encdec":
        kw["n_enc_layers"] = 2
    return dataclasses.replace(cfg, **kw, name=cfg.name + "-reduced")
