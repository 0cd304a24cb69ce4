"""Server-side optimizers: FedAvgM (Hsu et al.), FedAdam / FedYogi (Reddi)
(port of ``repro/core/strategies/fedavgm.py``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.strategy import Strategy, tree_zeros_like


@dataclasses.dataclass(frozen=True)
class FedAvgM(Strategy):
    """FedAvg with server-side Nesterov-style momentum."""
    name: str = "fedavgm"

    def server_state_init(self, params):
        """Zero momentum buffer, shaped like the params."""
        return {"momentum": tree_zeros_like(params)}

    def server_update(self, params, agg_delta, server_state):
        """Fold the aggregate delta into the momentum buffer and apply it."""
        beta = self.fl.server_momentum
        m = {k: beta * v + agg_delta[k].to(v.dtype)
             for k, v in server_state["momentum"].items()}
        new = {k: p + self.fl.server_lr * m[k].to(p.dtype)
               for k, p in params.items()}
        return new, {"momentum": m}


@dataclasses.dataclass(frozen=True)
class FedAdam(Strategy):
    """Server-side Adam on the aggregate client delta (FedOpt family)."""
    name: str = "fedadam"
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-3

    def server_state_init(self, params):
        """Zero first/second-moment buffers plus the step counter."""
        dev = next(iter(params.values())).device
        return {"m": tree_zeros_like(params), "v": tree_zeros_like(params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def _second_moment(self, v, d):
        return self.b2 * v + (1 - self.b2) * d * d

    def server_update(self, params, agg_delta, server_state):
        """One Adam step treating the aggregate delta as the gradient."""
        t = server_state["t"] + 1
        m = {k: self.b1 * v + (1 - self.b1) * agg_delta[k]
             for k, v in server_state["m"].items()}
        v = {k: self._second_moment(x, agg_delta[k])
             for k, x in server_state["v"].items()}
        new = {k: p + (self.fl.server_lr * m[k]
                       / (torch.sqrt(v[k]) + self.eps)).to(p.dtype)
               for k, p in params.items()}
        return new, {"m": m, "v": v, "t": t}


@dataclasses.dataclass(frozen=True)
class FedYogi(FedAdam):
    """FedAdam variant with Yogi's sign-based second-moment update."""
    name: str = "fedyogi"

    def _second_moment(self, v, d):
        d2 = d * d
        return v - (1 - self.b2) * d2 * torch.sign(v - d2)
