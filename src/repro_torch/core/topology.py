"""Network topologies as reductions over the client dim (port of the
meshless half of ``repro/core/topology.py``).

- client-server: one weighted mean over the clients.
- hierarchical: edge then cloud tier; with one device (no pod axis) both
  tiers collapse to the same weighted mean.
- decentralized: no global reduction; ``gossip_steps`` rounds of ring
  gossip over the client dim (doubly stochastic mixing), Fedstellar-style.
"""
from __future__ import annotations

import dataclasses
import difflib

import torch


def _wmean(deltas: dict, weights) -> dict:
    """deltas: (C, ...) leading client dim; weights: (C,). A product and a
    sum over the client dim, not a matrix-vector product, whose summation
    order would change with a campaign's extra lane dim."""
    den = torch.clamp(weights.sum(), min=1e-12)
    return {k: (weights.reshape(-1, *([1] * (d.dim() - 1))) * d.to(torch.float32)).sum(0)
            / den for k, d in deltas.items()}


@dataclasses.dataclass(frozen=True)
class ClientServer:
    """Star topology: weighted mean of client deltas at the server."""
    name: str = "client_server"

    def aggregate(self, deltas, weights):
        """Weighted mean over the leading client dim."""
        return _wmean(deltas, weights)


@dataclasses.dataclass(frozen=True)
class Hierarchical(ClientServer):
    """Edge aggregators first, then the cloud tier over pods; with one
    device (one pod) the two tiers give the same weighted mean."""
    name: str = "hierarchical"


@dataclasses.dataclass(frozen=True)
class Decentralized:
    """k steps of ring gossip; returns per-client mixed states (no global)."""
    name: str = "decentralized"
    gossip_steps: int = 1

    def mix(self, state: dict) -> dict:
        """state: per-client dict with a leading (C, ...) dim. One gossip
        step averages each client with its two ring neighbours, in f32
        (the accumulator, not the raw leaf, is rolled), cast back after."""
        def step(t):
            mixed = t.to(torch.float32)
            n = 1
            if t.shape[0] > 1:
                mixed = mixed + torch.roll(mixed, 1, 0) + torch.roll(mixed, -1, 0)
                n += 2
            return (mixed / n).to(t.dtype)

        for _ in range(self.gossip_steps):
            state = {k: step(v) for k, v in state.items()}
        return state

    def aggregate(self, deltas, weights):
        """Gossip-average deltas over the ring for ``gossip_steps``."""
        return self.mix(deltas)


# neighbours each client exchanges with per gossip step (the ring rolls ±1)
GOSSIP_NEIGHBORS = 2

_TOPOLOGIES = ("client_server", "hierarchical", "decentralized")


def get_topology(name: str, gossip_steps: int = 1):
    """Resolve a topology implementation by name."""
    if name == "client_server":
        return ClientServer()
    if name == "hierarchical":
        return Hierarchical()
    if name == "decentralized":
        return Decentralized(gossip_steps=gossip_steps)
    hint = difflib.get_close_matches(name, _TOPOLOGIES, n=1)
    suffix = (f" — did you mean {hint[0]!r}?" if hint
              else f"; known topologies: {list(_TOPOLOGIES)}")
    raise ValueError(f"unknown topology {name!r}{suffix}")
