"""Model registry and parameter accounting (port of
``repro/models/model_zoo.py`` for the families the port runs)."""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, get_config


def _check_ported(cfg: ModelConfig) -> None:
    """The dense and MoE decoder families with GQA or MLA attention (QKV
    bias, qk-norm and tied embeddings included); encoder-decoder, SSM and
    hybrid raise ``NotImplementedError`` naming their part of ROADMAP A15."""
    if cfg.family not in ("dense", "moe") or cfg.attn_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"model family {cfg.family!r} with {cfg.attn_type!r} attention is not "
            "yet ported (the port runs the small models and the dense and MoE "
            "decoders); encoder-decoder comes with ROADMAP A15.5, SSM and hybrid "
            "with A15.6")
    if cfg.attn_type == "mla" and cfg.mla is None:
        raise ValueError(f"{cfg.name}: MLA attention without an MLAConfig")
    if cfg.family == "moe" and cfg.moe is None:
        raise ValueError(f"{cfg.name}: the moe family without a MoEConfig")


def build(name_or_cfg):
    """The model for an arch name or a ``ModelConfig``: ``SmallModel`` for
    the paper's models, ``transformer.Model`` for the decoder LMs (dense
    GQA, MLA, MoE; tied or untied embeddings); anything else raises
    ``NotImplementedError``."""
    cfg = (name_or_cfg if isinstance(name_or_cfg, ModelConfig)
           else get_config(name_or_cfg))
    if cfg.family == "small":
        from repro_torch.models import small
        return small.build_small(cfg)
    _check_ported(cfg)
    from repro_torch.models import transformer
    return transformer.Model(cfg)


def _tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_numel(v) for v in tree.values())
    return math.prod(tree)


def count_params(cfg: ModelConfig, padded: bool = False,
                 active_only: bool = False) -> int:
    """Parameter count: a paper model's init leaves, or an LM's shape tree.

    ``padded=False`` leaves out the vocab padding (the paper-faithful N):
    once for the embedding and once more for an untied ``lm_head``.
    ``active_only`` counts top_k of each MoE layer's experts (the N of
    6 * N_active * D)."""
    if cfg.family == "small":
        from repro_torch.models import small
        return small.count_small_params(cfg)
    _check_ported(cfg)
    from repro_torch.models import transformer
    total = _tree_numel(transformer.param_shapes(cfg))
    if not padded:
        dv = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
        total -= dv if cfg.tie_embeddings else 2 * dv
    if active_only and cfg.moe is not None:
        m = cfg.moe
        n_moe_layers = cfg.n_layers // m.moe_every
        total -= n_moe_layers * (m.n_experts - m.top_k) * 3 * cfg.d_model * m.expert_d_ff
    return int(total)
