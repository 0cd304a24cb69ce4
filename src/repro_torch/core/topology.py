"""Network topologies as reduction plans over the client grid (port of
``repro/core/topology.py``).

- client-server: one weighted mean over the client grid.
- hierarchical: edge then cloud tier: the intra-pod ``(data, model)`` sum,
  divided, then the mean over ``pod``; with no pod axis both tiers give the
  same weighted mean.
- decentralized: no global reduction; ``gossip_steps`` rounds of ring
  gossip (doubly stochastic mixing), Fedstellar-style: over the client dim
  meshless, over the ``model`` then the ``data`` ring on a mesh.

A topology is bound to its ``AxisCtx`` when built (``get_topology(...,
ctx=)``). With ``SINGLE`` (the default) every plan is the meshless one;
with a mesh's axes each rank holds ``C_loc`` clients and the sums cross
the mesh (``sharding/axes.py``).
"""
from __future__ import annotations

import dataclasses
import difflib

import torch

from repro_torch.sharding.axes import SINGLE, AxisCtx, divisor


def _wmean_local(deltas: dict, weights):
    """The rank's weighted numerator of every leaf over its leading client
    dim: a product and a sum over the client dim, not a matrix-vector
    product, whose summation order would change with a campaign's extra
    lane dim."""
    return {k: (weights.reshape(-1, *([1] * (d.dim() - 1))) * d.to(torch.float32)).sum(0)
            for k, d in deltas.items()}


def _divide(num, den):
    den = torch.clamp(den, min=1e-12)
    if isinstance(num, dict):
        return {k: t / den for k, t in num.items()}
    return num / den


@dataclasses.dataclass(frozen=True)
class ClientServer:
    """Star topology: weighted mean of client deltas at the server."""
    name: str = "client_server"
    ctx: AxisCtx = SINGLE

    def reduce(self, num, den):
        """The weighted mean from this rank's numerator (a tensor or a dict
        of them) and weight sum, both summed over the whole grid ``(pod,
        data, model)``; meshless the sums are the rank's own."""
        axes = self.ctx.grid_axes
        return _divide(self.ctx.psum(num, axes), self.ctx.psum(den, axes))

    def aggregate(self, deltas, weights):
        """Weighted mean over the leading client dim (and the mesh)."""
        return self.reduce(_wmean_local(deltas, weights), weights.sum())


@dataclasses.dataclass(frozen=True)
class Hierarchical(ClientServer):
    """Edge aggregators first (within a pod: the data and model axes), then
    the cloud tier's mean over pods; with one pod the two tiers give the
    same weighted mean."""
    name: str = "hierarchical"

    def reduce(self, num, den):
        """Pod-local weighted means (sums over ``(data, model)``, divided),
        then their mean over ``pod``."""
        ctx = self.ctx
        intra = tuple(a for a in ctx.grid_axes if a != ctx.pod)
        return ctx.pmean(_divide(ctx.psum(num, intra), ctx.psum(den, intra)), ctx.pod)


@dataclasses.dataclass(frozen=True)
class Decentralized:
    """k steps of ring gossip; returns per-client mixed states (no global)."""
    name: str = "decentralized"
    gossip_steps: int = 1
    ctx: AxisCtx = SINGLE

    def mix(self, state: dict) -> dict:
        """state: per-client dict with a leading (C_loc, ...) dim. One
        gossip step averages each client with its two ring neighbours, in
        f32 (the accumulator, not the raw leaf, is exchanged), cast back
        after: meshless the neighbours on the client dim, on a mesh the
        same slot of the neighbouring ranks along ``model``, then along
        ``data``; an axis of size 1 exchanges with itself twice, as
        ``ppermute`` does."""
        ctx = self.ctx
        rings = [a for a in (ctx.model, ctx.data) if a is not None]
        lead = next(iter(state.values()))
        # each ring adds two neighbours; meshless, the roll over C > 1 clients
        n = 1 + 2 * (len(rings) if rings else int(lead.shape[0] > 1))
        div = divisor(n, lead.device)

        def step(t):
            mixed = t.to(torch.float32)
            for axis in rings:
                sz = ctx.size(axis)
                right = ctx.ppermute(mixed, axis, [(i, (i + 1) % sz) for i in range(sz)])
                left = ctx.ppermute(mixed, axis, [(i, (i - 1) % sz) for i in range(sz)])
                mixed = mixed + right + left
            if not rings and n > 1:
                mixed = mixed + torch.roll(mixed, 1, 0) + torch.roll(mixed, -1, 0)
            return (mixed / div).to(t.dtype)

        for _ in range(self.gossip_steps):
            state = {k: step(v) for k, v in state.items()}
        return state

    def aggregate(self, deltas, weights):
        """Gossip-average deltas over the ring for ``gossip_steps``."""
        return self.mix(deltas)


# neighbours each client exchanges with per gossip step (the ring rolls ±1)
GOSSIP_NEIGHBORS = 2

_TOPOLOGIES = ("client_server", "hierarchical", "decentralized")


def get_topology(name: str, gossip_steps: int = 1, ctx: AxisCtx = SINGLE):
    """Resolve a topology implementation by name, bound to ``ctx``."""
    if name == "client_server":
        return ClientServer(ctx=ctx)
    if name == "hierarchical":
        return Hierarchical(ctx=ctx)
    if name == "decentralized":
        return Decentralized(gossip_steps=gossip_steps, ctx=ctx)
    hint = difflib.get_close_matches(name, _TOPOLOGIES, n=1)
    suffix = (f" — did you mean {hint[0]!r}?" if hint
              else f"; known topologies: {list(_TOPOLOGIES)}")
    raise ValueError(f"unknown topology {name!r}{suffix}")
