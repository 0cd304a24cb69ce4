"""Model registry and parameter accounting (port of
``repro/models/model_zoo.py``)."""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, get_config


def _check_config(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for an LM config that lacks what its family
    needs: a known family, GQA or MLA attention, an MLAConfig for MLA, a
    MoEConfig for moe and hybrid, an SSMConfig for ssm and hybrid, a
    HybridConfig for hybrid, encoder layers for encdec."""
    if cfg.family not in ("dense", "moe", "encdec", "ssm", "hybrid"):
        raise ValueError(f"{cfg.name}: unknown model family {cfg.family!r}")
    if cfg.attn_type not in ("gqa", "mla"):
        raise ValueError(f"{cfg.name}: unknown attention {cfg.attn_type!r}")
    needs = {"mla": cfg.attn_type == "mla",
             "moe": cfg.family in ("moe", "hybrid"),
             "ssm": cfg.family in ("ssm", "hybrid"),
             "hybrid": cfg.family == "hybrid"}
    for field, needed in needs.items():
        if needed and getattr(cfg, field) is None:
            raise ValueError(f"{cfg.name}: the {cfg.family} family with {cfg.attn_type} "
                             f"attention needs a {field} config")
    if cfg.family == "encdec" and cfg.n_enc_layers <= 0:
        raise ValueError(f"{cfg.name}: the encdec family without encoder layers")


def build(name_or_cfg):
    """The model for an arch name or a ``ModelConfig``: ``SmallModel`` for
    the paper's models, ``transformer.EncDecModel`` for the encdec family
    and ``transformer.Model`` for the other LMs (dense GQA or MLA, MoE,
    xLSTM, the Mamba hybrid); a config lacking what its family needs
    raises ``ValueError``."""
    cfg = (name_or_cfg if isinstance(name_or_cfg, ModelConfig)
           else get_config(name_or_cfg))
    if cfg.family == "small":
        from repro_torch.models import small
        return small.build_small(cfg)
    _check_config(cfg)
    from repro_torch.models import transformer
    return transformer.build_model(cfg)


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
    6 * N_active * D): ``moe_every``'s share of the layers, and for the
    hybrid family ``period // moe_every`` a period."""
    if cfg.family == "small":
        from repro_torch.models import small
        return small.count_small_params(cfg)
    _check_config(cfg)
    from repro_torch.models import transformer
    total = _tree_numel(transformer.param_shapes(cfg))
    if not padded:
        dv = (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model
        total -= dv if cfg.tie_embeddings else 2 * dv
    if active_only and cfg.moe is not None:
        m = cfg.moe
        if cfg.family == "hybrid":
            n_moe_layers = (cfg.n_layers // cfg.hybrid.period) * (cfg.hybrid.period
                                                                  // m.moe_every)
        else:
            n_moe_layers = cfg.n_layers // m.moe_every
        total -= n_moe_layers * (m.n_experts - m.top_k) * 3 * cfg.d_model * m.expert_d_ff
    return int(total)
