"""Model registry (port of the small-family half of
``repro/models/model_zoo.build``)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, get_config


def build(name_or_cfg):
    """The model for an arch name or a ``ModelConfig`` (small family only)."""
    cfg = (name_or_cfg if isinstance(name_or_cfg, ModelConfig)
           else get_config(name_or_cfg))
    if cfg.family != "small":
        raise NotImplementedError(
            f"model family {cfg.family!r} is not yet ported, see ROADMAP A15")
    from repro_torch.models import small
    return small.build_small(cfg)
