"""Strategy registry (port of ``repro/core/strategies/__init__.py``): the
paper's seven frameworks and the extras."""
from __future__ import annotations

from repro_torch.configs.base import FLConfig
from repro_torch.core.strategies.compressed import CompressedFedAvg
from repro_torch.core.strategies.dp import DPFedAvg
from repro_torch.core.strategies.fedavgm import FedAdam, FedAvgM, FedYogi
from repro_torch.core.strategies.fedprox import FedProx
from repro_torch.core.strategies.moon import Moon
from repro_torch.core.strategies.scaffold import Scaffold
from repro_torch.core.strategy import Strategy

REGISTRY = {
    "fedavg": lambda fl: Strategy(fl, "fedavg"),
    "fedavgm": FedAvgM,
    "fedadam": FedAdam,
    "fedyogi": FedYogi,
    "fedprox": FedProx,
    "scaffold": Scaffold,
    "moon": Moon,
    "dp_fedavg": DPFedAvg,
    "compressed": CompressedFedAvg,
    # clustered and decentralized are topology-level (hierarchical,
    # decentralized) with plain fedavg local logic
    "clustered": lambda fl: Strategy(fl, "clustered"),
    "gossip": lambda fl: Strategy(fl, "gossip"),
}


def get_strategy(fl: FLConfig) -> Strategy:
    """Resolve the strategy named by ``fl.strategy``."""
    if fl.strategy not in REGISTRY:
        raise KeyError(f"unknown strategy {fl.strategy!r}: {sorted(REGISTRY)}")
    return REGISTRY[fl.strategy](fl)
