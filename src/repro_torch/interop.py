"""Weights carried between the JAX package and the port, as numpy.

The port keeps the JAX package's param names and layouts, so carrying a
state across is a dtype-preserving copy of each leaf. Tests use this to
start both packages from the same weights.
"""
from __future__ import annotations

import numpy as np
import torch


def _from_numpy(tree, device):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device) for k, v in tree.items()}
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


def to_numpy(tree):
    """The port's params or state -> the same structure of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # PackedDelta
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree.detach().cpu().numpy()
