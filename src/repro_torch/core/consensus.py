"""Multi-worker aggregation consensus (port of ``repro/core/consensus.py``;
paper §2.5, RQ3, Fig. 10).

Several workers each produce an aggregate; a consensus callable picks the
next global model. Mirrors the paper's 4-phase pipeline:
  (1) local parameter sharing  (2) aggregated-parameter voting
  (3) final global parameter   (4) distribution.

Runs on the device inside the round: W is small, aggregates are dicts of
tensors stacked on a leading worker dim. Digest voting uses a deterministic
random-projection fingerprint (the host ledger keeps exact SHA-256, see
``blockchain.py``). Byzantine workers are simulated by a poison transform.

The consensus callable signature matches the paper's Fig. 5:
  consensus(aggregated_models: (W, ...), extra: dict) -> chosen model

Randomness: the JAX package draws the projections and the poison from
``jax.random`` (threefry); here both are ``determinism.normal`` draws,
keyed by the same coordinates (a fixed tag folded with the leaf index for a
projection; the round key folded with the worker, then the leaf, for the
poison), with the same bits on the CPU and the card. With an honest
majority every consensus function returns the honest aggregate exactly, so
those runs are the same in both packages; poisoned values differ.

On a mesh (the temporal placement: the aggregate is a rank's shard of every
leaf, the round's view of the model ``shards`` a ``sharding/specs.
TreeShards``) the poison is drawn at each element's global flat index, and
a digest's projections of a leaf's
first 128 global entries are ``psum``med over the leaf's shards, so every
rank votes with the meshless digests and picks the meshless winner; median
and trimmed mean are coordinate-wise.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch

from repro_torch.core import determinism
from repro_torch.core.treeview import WHOLE, WholeTree

# key of the digest projections (leaf i draws from fold_in(_PROJ_KEY, i))
_PROJ_KEY = determinism.root_key(0xD16E57)
# the default poison key: stands for the JAX package's PRNGKey(666)
POISON_KEY = determinism.root_key(666)


@functools.lru_cache(maxsize=None)
def _projection(leaf_idx: int, width: int, n_proj: int, device: torch.device):
    """(n_proj, width) f32 standard normals of leaf ``leaf_idx``, drawn once
    per (leaf, shape, device): the same bits on every device."""
    ctr = torch.arange(n_proj * width, dtype=torch.int64, device=device)
    return determinism.normal(determinism.fold_in(_PROJ_KEY, leaf_idx),
                              ctr).reshape(n_proj, width)


def digest_nbytes(n_proj: int = 4) -> int:
    """Wire bytes of one digest vote: ``n_proj`` f32 projections (the comms
    plane bills consensus voting at this size, phase 2 of the pipeline)."""
    return 4 * n_proj


def digest(tree: dict, n_proj: int = 4, lead: int = 0, shards: WholeTree = WHOLE):
    """Deterministic fingerprint: projections of the first ``min(numel,
    128)`` entries of every leaf of the whole tree that ``shards`` views
    (``core/treeview``), in sorted-key order, summed. ``lead`` leading dims
    (a worker dim) are kept: (*lead, n_proj) f32. On a mesh ``tree`` is a
    rank's shards: the rank projects those of its entries that are among a
    leaf's first 128 whole ones (a prefix of its own, as its block keeps
    the row-major order) and the sums cross the mesh."""
    parts = {}
    for i, k in enumerate(sorted(tree)):
        leaf = tree[k]
        f = leaf.reshape(*leaf.shape[:lead], -1)
        width = min(math.prod(shards.whole_shape(k, leaf.shape[lead:])), 128)
        n = min(f.shape[-1], 128)
        gidx = shards.flat_index(k, leaf.device, 0, n)
        proj = _projection(i, width, n_proj, leaf.device)
        cols = proj[:, torch.clamp(gidx, max=width - 1)] * (gidx < width)
        parts[k] = f[..., :n].to(torch.float32) @ cols.T
    return shards.total(parts)


def _select(aggs: dict, winner) -> dict:
    """Worker ``winner`` (a 0-d device tensor: no host read) of every leaf."""
    return {k: t.index_select(0, winner.reshape(1))[0] for k, t in aggs.items()}


def majority_digest(aggs: dict, extra: dict) -> dict:
    """Pick the aggregate whose (quantized) digest has the most matches:
    an honest majority nullifies minority poisoners (Chowdhury et al. [13]).
    Ties go to the first worker with the most votes, as ``jnp.argmax``.
    ``extra["shards"]``: the round's view of the model (``digest``)."""
    digs = digest(aggs, lead=1, shards=extra.get("shards", WHOLE))   # (W, P)
    q = torch.round(digs * 1e4) / 1e4
    same = ((q[:, None] - q[None, :]).abs() < 1e-3).all(-1)   # (W, W)
    return _select(aggs, torch.argmax(same.sum(-1)))


COLUMNS = 1 << 24   # coordinates a coordinate-wise consensus takes at once


def _by_columns(f, t):
    """``f`` of a stacked leaf's (W, n) columns, ``COLUMNS`` at a time, as
    one (n,) result shaped like a worker's leaf: each coordinate is
    computed on its own, so this is bitwise ``f`` of the whole, with a
    sort's int64 indices a chunk's (an LM leaf's would be W x 8 bytes a
    value)."""
    flat = t.reshape(t.shape[0], -1)
    out = flat.new_empty(flat.shape[1:])
    for lo in range(0, flat.shape[1], COLUMNS):
        out[lo:lo + COLUMNS] = f(flat[:, lo:lo + COLUMNS])
    return out.reshape(t.shape[1:])


def median_select(aggs: dict, extra: dict) -> dict:
    """Coordinate-wise median across workers; at even W the midpoint of the
    two middle values, as ``jnp.median``."""
    def f(t):
        s = torch.sort(t, dim=0).values
        W = t.shape[0]
        if W % 2:
            return s[W // 2]
        return (s[W // 2 - 1] + s[W // 2]) * 0.5
    return {k: _by_columns(f, t) for k, t in aggs.items()}


def trimmed_mean(aggs: dict, extra: dict) -> dict:
    """Coordinate-wise trimmed mean over the workers (``extra["trim"]``
    from each end, 1 by default; the plain mean when W <= 2 * trim)."""
    trim = int(extra.get("trim", 1))

    def f(t):
        W = t.shape[0]
        if W <= 2 * trim:
            return t.mean(0)
        return torch.sort(t, dim=0).values[trim:W - trim].mean(0)
    return {k: _by_columns(f, t) for k, t in aggs.items()}


CONSENSUS_REGISTRY: dict[str, Callable] = {
    "majority_digest": majority_digest,
    "median": median_select,
    "trimmed_mean": trimmed_mean,
}


def poison(tree: dict, scale: float = 10.0, rng: int | None = None,
           shards: WholeTree = WHOLE) -> dict:
    """Model-poisoning transform for byzantine-worker simulation: leaf i
    gets ``scale`` times standard normals keyed by ``fold_in(rng, i)``,
    drawn on the leaf's device, each element at its flat index in its
    whole leaf (``shards``: the round's view of the model)."""
    rng = POISON_KEY if rng is None else rng
    out = {}
    for i, k in enumerate(sorted(tree)):
        leaf = tree[k]
        n = determinism.normal_at(determinism.fold_in(rng, i), leaf.numel(),
                                  functools.partial(shards.flat_index, k, leaf.device))
        out[k] = leaf + scale * n.reshape(leaf.shape).to(leaf.dtype)
    return out


@dataclasses.dataclass(frozen=True)
class MultiWorkerAggregator:
    """Wraps a base aggregate with W redundant workers + consensus."""
    n_workers: int
    byzantine: int
    consensus: str = "majority_digest"
    poison_scale: float = 3.0
    # the round's view of the model (``core/treeview``): a rank's shards on
    # a mesh
    shards: WholeTree = dataclasses.field(default=WHOLE, compare=False, repr=False)

    def run(self, agg_delta: dict, rng: int) -> dict:
        """agg_delta: the honest aggregate (all workers see the same client
        deltas; on a mesh the rank's shards); rng: the round key. Worker
        w < ``byzantine`` poisons its copy with ``fold_in(rng, w)``;
        consensus picks one."""
        fn = CONSENSUS_REGISTRY[self.consensus]
        versions = [poison(agg_delta, self.poison_scale, determinism.fold_in(rng, w),
                           self.shards)
                    if w < self.byzantine else agg_delta
                    for w in range(self.n_workers)]
        stacked = {k: torch.stack([v[k] for v in versions]) for k in agg_delta}
        del versions
        return fn(stacked, {"shards": self.shards})


def build_aggregator(fl, shards: WholeTree = WHOLE) -> MultiWorkerAggregator | None:
    """The job's multi-worker aggregator, or None for one honest worker
    (``shards``: the round's view of the model)."""
    if fl.n_workers > 1 or fl.byzantine_workers > 0:
        return MultiWorkerAggregator(fl.n_workers, fl.byzantine_workers,
                                     fl.consensus, shards=shards)
    return None
