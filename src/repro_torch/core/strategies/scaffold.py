"""SCAFFOLD (Karimireddy et al.): client/server control variates (port of
``repro/core/strategies/scaffold.py``).

The local gradient is corrected by (c - c_i); after K local steps the client
control variate updates by option II: c_i+ = c_i - c + (x - y_i)/(K·lr).
The round sets the server's c to the cohort-weighted mean of the clients'
c_i (``core/rounds.build_spatial_round``)."""
from __future__ import annotations

import dataclasses

from repro_torch.core.strategy import Strategy, tree_zeros_like


@dataclasses.dataclass(frozen=True)
class Scaffold(Strategy):
    """SCAFFOLD: control variates correcting client drift."""
    name: str = "scaffold"
    reads_client_state = True

    def server_state_init(self, params):
        """Zero server control variate, shaped like the params."""
        return {"c": tree_zeros_like(params)}

    def client_state_init(self, params):
        """Zero client control variate, shaped like the params."""
        return {"c_i": tree_zeros_like(params)}

    def grad_transform(self, grad, client_state, server_state):
        """Apply the SCAFFOLD correction ``g - c_i + c`` to (C, ...) grads."""
        ci, c = client_state["c_i"], server_state["c"]
        return {k: g - ci[k] + c[k] for k, g in grad.items()}

    def client_state_update(self, client_state, server_state, delta,
                            n_local_steps, lr):
        """Option-II update of the client control variate (delta = y_i - x)."""
        ci, c = client_state["c_i"], server_state["c"]
        return {"c_i": {k: v - c[k] - delta[k] / (n_local_steps * lr)
                        for k, v in ci.items()}}
