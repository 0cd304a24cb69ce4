"""Strategy registry (port of ``repro/core/strategies/__init__.py``): the
strategies of slice 1. The other names of the JAX registry resolve to a
``NotImplementedError`` until they are ported (ROADMAP A5)."""
from __future__ import annotations

from repro_torch.configs.base import FLConfig
from repro_torch.core.strategies.compressed import CompressedFedAvg
from repro_torch.core.strategy import Strategy

REGISTRY = {
    "fedavg": lambda fl: Strategy(fl, "fedavg"),
    "compressed": CompressedFedAvg,
}

NOT_YET_PORTED = ("fedavgm", "fedadam", "fedyogi", "fedprox", "scaffold",
                  "moon", "dp_fedavg", "clustered", "gossip")


def get_strategy(fl: FLConfig) -> Strategy:
    """Resolve the strategy named by ``fl.strategy``."""
    if fl.strategy in NOT_YET_PORTED:
        raise NotImplementedError(
            f"strategy {fl.strategy!r} is not yet ported, see ROADMAP A5")
    if fl.strategy not in REGISTRY:
        raise KeyError(f"unknown strategy {fl.strategy!r}: "
                       f"{sorted(REGISTRY) + sorted(NOT_YET_PORTED)}")
    return REGISTRY[fl.strategy](fl)
