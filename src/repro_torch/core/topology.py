"""Network topologies as reductions over the client dim (port of the
meshless half of ``repro/core/topology.py``).

- client-server: one weighted mean over the clients.
- hierarchical: edge then cloud tier; with one device (no pod axis) both
  tiers collapse to the same weighted mean.
- decentralized: gossip mixing, not yet ported (ROADMAP A6).
"""
from __future__ import annotations

import dataclasses
import difflib

import torch


def _wmean(deltas: dict, weights) -> dict:
    """deltas: (C, ...) leading client dim; weights: (C,)."""
    den = torch.clamp(weights.sum(), min=1e-12)
    return {k: torch.tensordot(weights, d.to(torch.float32), dims=1) / den
            for k, d in deltas.items()}


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


_TOPOLOGIES = ("client_server", "hierarchical", "decentralized")


def get_topology(name: str, gossip_steps: int = 1):
    """Resolve a topology implementation by name."""
    if name == "client_server":
        return ClientServer()
    if name == "hierarchical":
        return Hierarchical()
    if name == "decentralized":
        raise NotImplementedError(
            "topology 'decentralized' is not yet ported, see ROADMAP A6")
    hint = difflib.get_close_matches(name, _TOPOLOGIES, n=1)
    suffix = (f" — did you mean {hint[0]!r}?" if hint
              else f"; known topologies: {list(_TOPOLOGIES)}")
    raise ValueError(f"unknown topology {name!r}{suffix}")
