"""Weights and caches carried between the JAX package and the port, as numpy.

The port keeps the JAX package's param names and layouts (LM blocks too:
nested dicts with the stacked leading layer dim), so carrying a state across
is a dtype-preserving copy of each leaf. Tests use this to start both
packages from the same weights, and to carry caches and recurrent states
(KV, MLA latent, encoder-decoder, Mamba, mLSTM and sLSTM, and the per-period
trees of the hybrid and xLSTM stacks) from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch


def _from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_from_numpy(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_from_numpy(v, device) for v in tree)
    return torch.tensor(np.asarray(tree), device=device)


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """A dict of numpy arrays (``SmallModel.init`` output) -> the port's
    params, same names and layouts."""
    return _from_numpy(dict(tree), device)


def state_from_numpy(state: dict, device="cpu") -> dict:
    """A whole ``{"params", "server", "clients"}`` state of numpy leaves
    (client state with its leading client dim) -> the port's state."""
    return {k: _from_numpy(state[k], device)
            for k in ("params", "server", "clients")}


def _port_cache_types() -> dict:
    from repro_torch.models.attention import KVCache, LatentCache
    from repro_torch.models.ssm import MambaState, MLSTMState, SLSTMState
    from repro_torch.models.transformer import EncDecCaches
    return {t.__name__: t for t in (KVCache, LatentCache, EncDecCaches, MambaState,
                                    MLSTMState, SLSTMState)}


def caches_from_numpy(tree, device="cpu"):
    """A JAX cache tree of numpy leaves (what ``Model.prefill`` gives, or a
    layer's state: dicts, lists and the JAX package's cache NamedTuples) ->
    the same tree of tensors, each NamedTuple as the port's type of that
    name (``KVCache``, ``LatentCache``, ``EncDecCaches``, ``MambaState``,
    ``MLSTMState``, ``SLSTMState``)."""
    types = _port_cache_types()

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return types[type(t).__name__](*(conv(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(conv(v) for v in t)
        return torch.tensor(np.asarray(t), device=device)
    return conv(tree)


def to_numpy(tree):
    """The port's params, state or KV cache -> the same structure of numpy
    arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # PackedDelta, the caches
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()


def specs_from_jax(tree):
    """A tree of JAX ``PartitionSpec``s (nested dicts; any object that
    iterates over its entries) -> the port's specs: a tuple per leaf, each
    entry None, an axis name, or a tuple of names."""
    if isinstance(tree, dict):
        return {k: specs_from_jax(v) for k, v in tree.items()}
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e for e in tree)
