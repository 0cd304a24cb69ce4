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
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import torch

from repro_torch.core import determinism

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


def digest(tree: dict, n_proj: int = 4, lead: int = 0):
    """Deterministic fingerprint: projections of the first ``min(numel,
    128)`` entries of every leaf, in sorted-key order, summed. ``lead``
    leading dims (a worker dim) are kept: (*lead, n_proj) f32."""
    acc = 0
    for i, k in enumerate(sorted(tree)):
        leaf = tree[k]
        f = leaf.reshape(*leaf.shape[:lead], -1)
        width = min(f.shape[-1], 128)
        proj = _projection(i, width, n_proj, leaf.device)
        acc = acc + f[..., :width].to(torch.float32) @ proj.T
    return acc


def _select(aggs: dict, winner) -> dict:
    """Worker ``winner`` (a 0-d device tensor: no host read) of every leaf."""
    return {k: t.index_select(0, winner.reshape(1))[0] for k, t in aggs.items()}


def majority_digest(aggs: dict, extra: dict) -> dict:
    """Pick the aggregate whose (quantized) digest has the most matches:
    an honest majority nullifies minority poisoners (Chowdhury et al. [13]).
    Ties go to the first worker with the most votes, as ``jnp.argmax``."""
    digs = digest(aggs, lead=1)                                # (W, P)
    q = torch.round(digs * 1e4) / 1e4
    same = ((q[:, None] - q[None, :]).abs() < 1e-3).all(-1)   # (W, W)
    return _select(aggs, torch.argmax(same.sum(-1)))


def median_select(aggs: dict, extra: dict) -> dict:
    """Coordinate-wise median across workers; at even W the midpoint of the
    two middle values, as ``jnp.median``."""
    def f(t):
        s = torch.sort(t, dim=0).values
        W = t.shape[0]
        if W % 2:
            return s[W // 2]
        return (s[W // 2 - 1] + s[W // 2]) * 0.5
    return {k: f(t) for k, t in aggs.items()}


def trimmed_mean(aggs: dict, extra: dict) -> dict:
    """Coordinate-wise trimmed mean over the workers (``extra["trim"]``
    from each end, 1 by default; the plain mean when W <= 2 * trim)."""
    trim = int(extra.get("trim", 1))

    def f(t):
        W = t.shape[0]
        if W <= 2 * trim:
            return t.mean(0)
        return torch.sort(t, dim=0).values[trim:W - trim].mean(0)
    return {k: f(t) for k, t in aggs.items()}


CONSENSUS_REGISTRY: dict[str, Callable] = {
    "majority_digest": majority_digest,
    "median": median_select,
    "trimmed_mean": trimmed_mean,
}


def poison(tree: dict, scale: float = 10.0, rng: int | None = None) -> dict:
    """Model-poisoning transform for byzantine-worker simulation: leaf i
    gets ``scale`` times standard normals keyed by ``fold_in(rng, i)``,
    drawn on the leaf's device."""
    rng = POISON_KEY if rng is None else rng
    out = {}
    for i, k in enumerate(sorted(tree)):
        leaf = tree[k]
        ctr = torch.arange(leaf.numel(), dtype=torch.int64, device=leaf.device)
        n = determinism.normal(determinism.fold_in(rng, i), ctr).reshape(leaf.shape)
        out[k] = leaf + scale * n.to(leaf.dtype)
    return out


@dataclasses.dataclass(frozen=True)
class MultiWorkerAggregator:
    """Wraps a base aggregate with W redundant workers + consensus."""
    n_workers: int
    byzantine: int
    consensus: str = "majority_digest"
    poison_scale: float = 3.0

    def run(self, agg_delta: dict, rng: int) -> dict:
        """agg_delta: the honest aggregate (all workers see the same client
        deltas); rng: the round key. Worker w < ``byzantine`` poisons its
        copy with ``fold_in(rng, w)``; consensus picks one."""
        fn = CONSENSUS_REGISTRY[self.consensus]
        versions = [poison(agg_delta, self.poison_scale, determinism.fold_in(rng, w))
                    if w < self.byzantine else agg_delta
                    for w in range(self.n_workers)]
        stacked = {k: torch.stack([v[k] for v in versions]) for k in agg_delta}
        return fn(stacked, {})


def build_aggregator(fl) -> MultiWorkerAggregator | None:
    """The job's multi-worker aggregator, or None for one honest worker."""
    if fl.n_workers > 1 or fl.byzantine_workers > 0:
        return MultiWorkerAggregator(fl.n_workers, fl.byzantine_workers,
                                     fl.consensus)
    return None
