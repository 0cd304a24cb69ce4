"""Weights and caches carried between the JAX package and the port, as numpy.

The port keeps the JAX package's param names and layouts (LM blocks too:
nested dicts with the stacked leading layer dim), so carrying a state across
is a dtype-preserving copy of each leaf. Tests use this to start both
packages from the same weights, and to compare KV and MLA latent caches.
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


def kv_cache_from_numpy(cache, device="cpu"):
    """A JAX ``KVCache`` (or any ``(k, v)`` pair) of numpy arrays -> the
    port's ``KVCache``, same layout."""
    from repro_torch.models.attention import KVCache
    k, v = cache
    return KVCache(*_from_numpy((k, v), device))


def latent_cache_from_numpy(cache, device="cpu"):
    """A JAX ``LatentCache`` (or any ``(ckv, krope)`` pair) of numpy arrays
    -> the port's ``LatentCache``, same layout."""
    from repro_torch.models.attention import LatentCache
    ckv, krope = cache
    return LatentCache(*_from_numpy((ckv, krope), device))


def to_numpy(tree):
    """The port's params, state or KV cache -> the same structure of numpy
    arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # PackedDelta, KVCache, LatentCache
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
