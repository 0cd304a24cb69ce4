"""FedProx (Li et al.): proximal term against the global model (port of
``repro/core/strategies/fedprox.py``).

The term is the whole model's through the round's view of it
(``Strategy.shards``): on a mesh each element counted once, and its
gradient the meshless one (``TreeShards.loss_term``); the JAX package's
``shard_map`` round takes it over each rank's shard (ROADMAP C13)."""
from __future__ import annotations

import dataclasses

from repro_torch.core.strategy import Strategy


@dataclasses.dataclass(frozen=True)
class FedProx(Strategy):
    """FedAvg with a proximal term pulling local params toward the global."""
    name: str = "fedprox"

    def local_loss(self, base_loss, params, global_params, batch,
                   client_state, rng):
        """Task loss plus ``prox_mu/2 * ||w - w_global||^2`` (one client)."""
        loss = base_loss(params, batch)
        diff = {k: params[k] - global_params[k] for k in params}
        return loss + self.shards.loss_term(0.5 * self.fl.prox_mu
                                            * self.shards.sq_norm(diff))
