"""FedProx (Li et al.): proximal term against the global model (port of
``repro/core/strategies/fedprox.py``)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.strategy import Strategy


@dataclasses.dataclass(frozen=True)
class FedProx(Strategy):
    """FedAvg with a proximal term pulling local params toward the global."""
    name: str = "fedprox"

    def local_loss(self, base_loss, params, global_params, batch,
                   client_state, rng):
        """Task loss plus ``prox_mu/2 * ||w - w_global||^2`` (one client)."""
        loss = base_loss(params, batch)
        prox = sum(torch.square((params[k] - global_params[k]).to(torch.float32)).sum()
                   for k in sorted(params))
        return loss + 0.5 * self.fl.prox_mu * prox
