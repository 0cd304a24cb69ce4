"""Dataset distribution (paper component 3: Dataset Distributor).

A numpy copy of ``repro/data/partition.py``: same ``RandomState`` draws, so
partitions are bitwise the JAX package's.

Implements FLsim's ``distribute_into_chunks`` contract: deterministic
partition of a root dataset into per-client chunks under
- ``dirichlet`` — label-Dirichlet(alpha) non-IID (the paper's experiments use
  alpha = 0.5 on CIFAR-10),
- ``iid``       — uniform shuffle-split,
- ``shards``    — sort-by-label shard assignment (McMahan-style pathological
  non-IID).
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2,
                        max_retries: int = 100):
    """Returns list of index arrays, one per client.

    Draws are resampled until every client holds ``min_size`` items, bounded
    by ``max_retries`` (each retry forks the RNG forward, so retry r of one
    call equals retry r of any other call with the same seed). A tiny alpha
    with many clients concentrates nearly all mass on a few clients, which
    used to hang forever here — now it raises with the offending settings.
    """
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    for _ in range(max_retries):
        idx_by_client = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.repeat(alpha, n_clients))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_by_client[i].extend(part.tolist())
        sizes = [len(ix) for ix in idx_by_client]
        if min(sizes) >= min_size:
            return [np.array(sorted(ix)) for ix in idx_by_client]
    raise ValueError(
        f"dirichlet_partition: no draw gave every client >= {min_size} "
        f"items after {max_retries} retries (alpha={alpha}, "
        f"n_clients={n_clients}, n_items={len(labels)}); raise alpha, "
        "lower n_clients/min_size, or add data")


def iid_partition(n_items: int, n_clients: int, seed: int = 0):
    """Shuffle items uniformly into ``n_clients`` equal shards."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n_items)
    return [np.sort(p) for p in np.array_split(perm, n_clients)]


def shard_partition(labels: np.ndarray, n_clients: int,
                    shards_per_client: int = 2, seed: int = 0):
    """Sort-by-label shard partition (pathological non-IID)."""
    rng = np.random.RandomState(seed)
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, n_clients * shards_per_client)
    assign = rng.permutation(len(shards))
    out = []
    for i in range(n_clients):
        ids = np.concatenate([shards[assign[i * shards_per_client + j]]
                              for j in range(shards_per_client)])
        out.append(np.sort(ids))
    return out


def partition(kind: str, labels: np.ndarray, n_clients: int,
              alpha: float = 0.5, seed: int = 0):
    """Dispatch to a partitioner by name (``iid`` | ``dirichlet`` | ``shards``)."""
    if kind == "dirichlet":
        return dirichlet_partition(labels, n_clients, alpha, seed)
    if kind == "iid":
        return iid_partition(len(labels), n_clients, seed)
    if kind == "shards":
        return shard_partition(labels, n_clients, seed=seed)
    raise KeyError(kind)


def heterogeneity(parts, labels: np.ndarray) -> float:
    """Mean total-variation distance of client label dists vs global —
    0 = IID; grows as alpha shrinks. Used by tests/benches."""
    n_classes = int(labels.max()) + 1
    glob = np.bincount(labels, minlength=n_classes) / len(labels)
    tvs = []
    for ix in parts:
        if len(ix) == 0:
            continue
        loc = np.bincount(labels[ix], minlength=n_classes) / len(ix)
        tvs.append(0.5 * np.abs(loc - glob).sum())
    return float(np.mean(tvs))
