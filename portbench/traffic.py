"""The inputs of every cell, made from ``--seed`` by general generators
that read a workload file's ``traffic`` parameters. The same seed gives the
same inputs on the same kind of device; each generator draws on the device
it is given, in a few large calls.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for one use of ``seed``, named by ``tags``."""
    h = hashlib.blake2b(repr((int(seed),) + tags).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(seed: int, device, *tags) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g


def vision(t: dict, seed: int, device):
    """A labelled image set: ``n_items`` images of ``shape`` (H, W, C),
    each its class's prototype (N(0, 1)) plus ``noise`` times N(0, 1), the
    labels uniform over ``classes``. Returns (x f32, y int64) on
    ``device``."""
    g = generator(seed, device, "vision")
    shape = tuple(t["shape"])
    y = torch.randint(0, t["classes"], (t["n_items"],), generator=g, device=device)
    protos = torch.randn((t["classes"], *shape), generator=g, device=device)
    x = torch.randn((t["n_items"], *shape), generator=g, device=device).mul_(t["noise"])
    return x.add_(protos[y]), y


def dirichlet_parts(y: np.ndarray, t: dict, seed: int) -> list:
    """Each client's item indices: every class's items split over the
    ``n_clients`` by proportions drawn from Dirichlet(``alpha``), drawn
    again until each client holds at least ``min_items`` (the label-skew
    partition of NIID-Bench, Li et al., ICDE 2022)."""
    rng = np.random.default_rng(derive(seed, "parts"))
    n, classes = t["n_clients"], int(y.max()) + 1
    by_class = [rng.permutation(np.flatnonzero(y == c)) for c in range(classes)]
    while True:
        parts = [[] for _ in range(n)]
        for idx in by_class:
            cuts = (np.cumsum(rng.dirichlet([t["alpha"]] * n)) * len(idx)).astype(int)[:-1]
            for c, piece in enumerate(np.split(idx, cuts)):
                parts[c].append(piece)
        parts = [np.sort(np.concatenate(p)) for p in parts]
        if min(len(p) for p in parts) >= t["min_items"]:
            return parts


def lm_tokens(t: dict, vocab: int, seed: int, round_idx: int, device):
    """One round's token rows for the cohort: (clients, local_steps, batch,
    seq) ids uniform over the vocabulary, and the next-token labels."""
    g = generator(seed, device, "tokens", round_idx)
    ids = torch.randint(0, vocab, (t["cohort"], t["local_steps"], t["batch"], t["seq"] + 1),
                        generator=g, device=device)
    return ids[..., :-1].contiguous(), ids[..., 1:].contiguous()
