"""MOON (Li et al.): model-contrastive local loss (port of
``repro/core/strategies/moon.py``).

As in the JAX package, the representation is the parameter-space drift: the
contrastive term penalises drifting in the same direction as the previous
round, through a bounded similarity that stays differentiable at zero."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.strategy import Strategy, tree_sub, tree_zeros_like


def _cos(a: dict, b: dict):
    """Smooth bounded similarity ``2<a,b> / (|a|^2 + |b|^2 + eps)`` of one
    client's trees: a plain cosine has no gradient at a == 0, which is where
    every round's first local step starts (params == global)."""
    keys = sorted(a)
    num = sum((a[k].to(torch.float32) * b[k].to(torch.float32)).sum() for k in keys)
    den = sum(torch.square(a[k].to(torch.float32)).sum() for k in keys) + \
        sum(torch.square(b[k].to(torch.float32)).sum() for k in keys) + 1e-12
    return 2.0 * num / den


@dataclasses.dataclass(frozen=True)
class Moon(Strategy):
    """Model-contrastive federated learning (MOON) over parameter space."""
    name: str = "moon"
    reads_client_state = True

    def client_state_init(self, params):
        """Previous round's local drift (the contrastive negative)."""
        return {"prev_local": tree_zeros_like(params)}

    def local_loss(self, base_loss, params, global_params, batch,
                   client_state, rng):
        """Task loss plus the model-contrastive term (mu, tau weighted)."""
        loss = base_loss(params, batch)
        sim = _cos(tree_sub(params, global_params), client_state["prev_local"])
        return loss + self.fl.moon_mu * F.softplus(sim / self.fl.moon_tau)

    def client_state_update(self, client_state, server_state, delta,
                            n_local_steps, lr):
        """Carry this round's delta to the next round."""
        return {"prev_local": dict(delta)}
