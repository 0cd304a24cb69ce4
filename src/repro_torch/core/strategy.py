"""FL Strategy base (port of ``repro/core/strategy.py``).

A Strategy is a set of hooks over param dicts. In the port the client dim is
written out: ``delta``, ``client_state`` and gradients carry a leading
``(C, ...)`` client dim and ``rng`` is a ``(C,)`` int64 tensor of client keys
(``determinism.client_key``), except inside ``local_loss``, which runs per
client under ``torch.func.vmap`` and sees one client's key.

  local_loss       — decorate the base loss (FedProx proximal term, MOON ...)
  grad_transform   — adjust the local gradient (SCAFFOLD control variates)
  postprocess      — transform the client delta before aggregation (DP, int8)
  server_update    — turn the aggregated delta + server state into new params
  *_state_init     — per-client / server state (momenta, control variates)

A hook defined on the whole model (DP's clip and noise, FedProx's prox
term) computes through the ``shards`` field, the round's view of the model
(``core/treeview``): ``WHOLE`` off a mesh, a ``sharding/specs.TreeShards``
where every param and delta is the rank's ZeRO-3 shard (the temporal
placement on a mesh), so the hook computes the meshless function on both;
hooks that act element by element ignore it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.treeview import WHOLE, WholeTree

PyTree = Any


def tree_zeros_like(t: dict) -> dict:
    """Dict of zeros matching ``t``'s leaves."""
    return {k: torch.zeros_like(v) for k, v in t.items()}


def tree_add(a: dict, b: dict, scale=1.0) -> dict:
    """Leafwise ``a + scale * b``."""
    return {k: a[k] + scale * b[k] for k in a}


def tree_sub(a: dict, b: dict) -> dict:
    """Leafwise ``a - b``."""
    return {k: a[k] - b[k] for k in a}


def tree_scale(a: dict, s) -> dict:
    """Leafwise ``s * a``."""
    return {k: v * s for k, v in a.items()}


def global_norm(t: dict, lead: int = 0, shards: WholeTree = WHOLE):
    """L2 norm over a dict's leaves, in f32, reducing every dim past the
    first ``lead`` (``lead=1``: one norm per client), of the whole tree
    that ``shards`` views (``core/treeview``). The 1e-24, as in the JAX
    package, keeps the sqrt differentiable at an all-zero tree."""
    return torch.sqrt(1e-24 + shards.sq_norm(t, lead))


@dataclasses.dataclass(frozen=True)
class Strategy:
    """FedAvg — weighted parameter averaging (McMahan et al.). Base class."""
    fl: FLConfig
    name: str = "fedavg"
    # the round's view of the model (``core/treeview``): a rank's shards on
    # a mesh
    shards: WholeTree = dataclasses.field(default=WHOLE, compare=False, repr=False)
    # hooks that index the per-client state: such a strategy cannot run
    # where the round passes none (temporal placement, async)
    reads_client_state = False

    # -- state ---------------------------------------------------------
    def server_state_init(self, params) -> PyTree:
        """Initial server-side optimizer state (default: none)."""
        return ()

    def client_state_init(self, params) -> PyTree:
        """Initial state of ONE client (default: none); the caller stacks it
        over the client dim."""
        return ()

    # -- local training hooks -------------------------------------------
    def local_loss(self, base_loss: Callable, params, global_params, batch,
                   client_state, rng):
        """base_loss(params, batch) -> loss, for one client; override to add
        regularizers that see the global params."""
        return base_loss(params, batch)

    def grad_transform(self, grad, client_state, server_state):
        """Hook transforming local gradients before the SGD step."""
        return grad

    def client_state_update(self, client_state, server_state, delta,
                            n_local_steps, lr):
        """Hook producing the client state carried to the next round."""
        return client_state

    # -- delta pipeline ---------------------------------------------------
    def postprocess(self, delta, client_state, rng):
        """Client-side delta transform (clip/noise/compress). Returns
        (delta, new_client_state)."""
        return delta, client_state

    @property
    def packs_deltas(self) -> bool:
        """True when clients emit ``packing.PackedDelta`` (int8 + block
        scales) via ``postprocess_packed``; the round then aggregates through
        ``kernels/ops.quant_aggregate`` instead of a dense f32 mean."""
        return False

    def postprocess_packed(self, delta, client_state, rng, out=None):
        """Packed counterpart of ``postprocess``: returns
        (PackedDelta, new_client_state), written into ``out`` (a
        ``PackedDelta`` of rows) where given. Only called when
        ``packs_deltas``."""
        raise NotImplementedError(
            f"{self.name}: packs_deltas is True but postprocess_packed "
            "is not implemented")

    # -- server -----------------------------------------------------------
    def server_update(self, params, agg_delta, server_state):
        """params + aggregated delta (server_lr scaled). Returns
        (new_params, new_server_state)."""
        return tree_add(params, agg_delta, self.fl.server_lr), server_state


def client_sgd_step(params, grad, lr, momentum_state=None, momentum=0.0):
    """The client-side optimizer used by local epochs."""
    if momentum and momentum_state is not None:
        new_m = {k: momentum * momentum_state[k] + grad[k] for k in grad}
        return ({k: p - lr * new_m[k].to(p.dtype) for k, p in params.items()},
                new_m)
    return ({k: p - lr * grad[k].to(p.dtype) for k, p in params.items()},
            momentum_state)
