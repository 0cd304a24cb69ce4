"""A round's view of the flat param tree it holds, through which every
whole-model quantity is computed: a sum over the leaves (``total``,
``sq_norm``), each element's flat index in its leaf (``flat_index``, the
counters of the counter-based draws), a leaf's whole shape
(``whole_shape``) and a loss term added on every rank (``loss_term``).

``WHOLE`` is the view of a whole tree (every round off a mesh).
``sharding/specs.TreeShards`` is a mesh rank's view of its shards of every
leaf: its sums cross the mesh and its indices are global, so the strategies
(DP's clip and noise, FedProx's term), the probes and the consensus (digest
and poison) compute one function on and off the mesh.
"""
from __future__ import annotations

import torch


class WholeTree:
    """The view of a tree that holds every leaf whole."""

    def total(self, parts: dict):
        """The sum over the leaves, in sorted-key order, of ``parts[k]``
        (leaf k's partial sums, tensors of one shape); a 0-d f32 zero for
        no leaves."""
        out = None
        for k in sorted(parts):
            out = parts[k] if out is None else out + parts[k]
        return torch.zeros((), dtype=torch.float32) if out is None else out

    def sq_norm(self, tree: dict, lead: int = 0):
        """The tree's sum of squares in f32, reducing every dim past the
        first ``lead`` (``lead=1``: one sum per client)."""
        return self.total({k: torch.square(t.to(torch.float32)).sum(
            dim=tuple(range(lead, t.dim()))) for k, t in tree.items()})

    def flat_index(self, key: str, device, lo: int, hi: int):
        """(hi - lo,) int64: the row-major flat indices in leaf ``key`` of
        the elements at this view's flat positions ``lo .. hi - 1``."""
        return torch.arange(lo, hi, dtype=torch.int64, device=device)

    def whole_shape(self, key: str, shape) -> tuple:
        """The shape of leaf ``key`` whole, of which this view holds a
        block of ``shape``."""
        return tuple(shape)

    def loss_term(self, x):
        """A loss term every holder of the tree adds whole (FedProx's), as
        its gradient must enter each leaf."""
        return x


WHOLE = WholeTree()
