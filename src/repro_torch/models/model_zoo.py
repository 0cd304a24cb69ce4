"""Model registry and parameter accounting (port of
``repro/models/model_zoo.py`` for the families the port runs)."""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, get_config


def _check_dense_gqa(cfg: ModelConfig) -> None:
    """Dense GQA, with or without QKV bias and qk-norm; anything else
    raises ``NotImplementedError`` naming ROADMAP A15."""
    if cfg.family != "dense" or cfg.attn_type != "gqa":
        raise NotImplementedError(
            f"model family {cfg.family!r} with {cfg.attn_type!r} attention is not "
            "yet ported (the port runs the small models and dense GQA), see "
            "ROADMAP A15")
    if cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: tie_embeddings not yet ported, see ROADMAP A15")


def build(name_or_cfg):
    """The model for an arch name or a ``ModelConfig``: ``SmallModel`` for
    the paper's models, the dense ``transformer.Model`` for dense GQA LMs
    (yi-34b, qwen2.5-32b, qwen1.5-32b, chameleon-34b); anything else raises
    ``NotImplementedError``."""
    cfg = (name_or_cfg if isinstance(name_or_cfg, ModelConfig)
           else get_config(name_or_cfg))
    if cfg.family == "small":
        from repro_torch.models import small
        return small.build_small(cfg)
    _check_dense_gqa(cfg)
    from repro_torch.models import transformer
    return transformer.Model(cfg)


def _tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(_tree_numel(v) for v in tree.values())
    return math.prod(tree)


def count_params(cfg: ModelConfig, padded: bool = False) -> int:
    """Parameter count: a paper model's init leaves, or a dense GQA LM's
    shape tree, where ``padded=False`` leaves out the vocab padding of embed
    and lm_head (the paper-faithful N)."""
    if cfg.family == "small":
        from repro_torch.models import small
        return small.count_small_params(cfg)
    _check_dense_gqa(cfg)
    from repro_torch.models import transformer
    total = _tree_numel(transformer.param_shapes(cfg))
    if not padded:
        total -= 2 * (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
    return int(total)
