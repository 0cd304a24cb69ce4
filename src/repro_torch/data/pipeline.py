"""Deterministic synthetic data + device-resident staging (port of the
resident subset of ``repro/data/pipeline.py``, campaigns' deduplicated
staging included).

``SyntheticVision`` is the same numpy ``RandomState`` generator as the JAX
package's, so root data are bitwise equal. Staging puts the whole root set
and the padded partition index matrix on the device once; every round then
gathers its batches there with no host round-trip.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import determinism
from repro_torch.data import partition as part_mod


def _pad_idx(parts, lmax: int) -> np.ndarray:
    """Ragged per-client index lists -> dense (C, lmax) int32 by cyclic
    repetition. Gather positions are drawn in [0, true len), so pad columns
    past a client's length are never read."""
    idx = np.zeros((len(parts), lmax), np.int32)
    for c, p in enumerate(parts):
        if len(p):
            reps = int(np.ceil(lmax / len(p)))
            idx[c] = np.concatenate([p] * reps)[:lmax]
    return idx


def stage_partitions(x, y, parts, device) -> dict:
    """One-time device staging of the root dataset + client partitions.

    Returns tensors on ``device``:

      x    (N, ...) f32 root features    y    (N,) int64 root labels
      idx  (C, Lmax) int64 item indices  len  (C,) int64 true partition sizes

    ``len`` doubles as the FedAvg base weight, so zero-item clients get zero
    weight automatically.
    """
    lmax = max(max((len(p) for p in parts), default=1), 1)
    lens = np.asarray([len(p) for p in parts], np.int64)
    return {"x": torch.as_tensor(np.asarray(x, np.float32), device=device),
            "y": torch.as_tensor(np.asarray(y, np.int64), device=device),
            "idx": torch.as_tensor(_pad_idx(parts, lmax).astype(np.int64),
                                   device=device),
            "len": torch.as_tensor(lens, device=device)}


# a campaign's staged planes: the concatenated roots are shared by every
# lane, the partition index and sizes carry the lane dim (the vmap dims of
# ``core/rounds.DEDUP_STAGED_DIMS``)
DEDUP_STAGED_AXES = {"x": None, "y": None, "idx": 0, "len": 0}


def stage_partitions_dedup(trajectories, keys, device):
    """Stage S trajectories' ``(x, y, parts)`` with the root datasets
    deduplicated: lanes with equal ``keys`` (the campaign's (seed,
    partition, alpha)) share ONE device copy. The unique roots are
    concatenated along the item axis and each lane's padded index matrix
    is offset into the concatenation, so a lane's gather reads the bytes
    its single run reads. Returns ``(staged, lane_ds)``:

      x ((sum_u N_u), ...) f32   y ((sum_u N_u),) int64   shared roots
      idx (S, C, Lmax) int64     len (S, C) int64         per lane

    and ``lane_ds`` (S,) int, each lane's unique root."""
    keys = list(keys)
    if len(keys) != len(trajectories):
        raise ValueError(f"{len(keys)} dedup keys for {len(trajectories)} trajectories")
    if len({len(parts) for _, _, parts in trajectories}) != 1:
        raise ValueError("trajectories disagree on n_clients")
    uniq, roots = {}, []
    for k, t in zip(keys, trajectories):
        if k not in uniq:
            uniq[k] = len(roots)
            roots.append(t)
    lane_ds = np.asarray([uniq[k] for k in keys], np.int64)
    lmax = max(max((max((len(p) for p in parts), default=1), 1)
                   for _, _, parts in roots))
    offsets = np.concatenate([[0], np.cumsum([np.asarray(x).shape[0]
                                              for x, _, _ in roots])])
    pads = [_pad_idx(parts, lmax).astype(np.int64) + int(offsets[u])
            for u, (_, _, parts) in enumerate(roots)]
    lens = [np.asarray([len(p) for p in parts], np.int64) for _, _, parts in roots]
    staged = {
        "x": torch.as_tensor(np.concatenate([np.asarray(x, np.float32)
                                             for x, _, _ in roots]), device=device),
        "y": torch.as_tensor(np.concatenate([np.asarray(y, np.int64)
                                             for _, y, _ in roots]), device=device),
        "idx": torch.as_tensor(np.stack([pads[u] for u in lane_ds]), device=device),
        "len": torch.as_tensor(np.stack([lens[u] for u in lane_ds]), device=device)}
    return staged, lane_ds


def _positions(keys, lens, n_steps: int, batch_size: int):
    """(..., n_steps, B) int64 positions in ``[0, lens)``, one counter-based
    draw per ``(batch key, step, slot)``; ``keys`` and ``lens`` broadcast."""
    ctr = torch.arange(n_steps * batch_size, dtype=torch.int64,
                       device=lens.device)
    pos = determinism.uniform_index(keys, ctr, lens.clamp(min=1))
    return pos.reshape(*pos.shape[:-1], n_steps, batch_size)


def gather_one_client_batch(staged, round_key: int, client: int,
                            batch_size: int, n_steps: int) -> dict:
    """Batch gather for one client, on the staged device.

    Positions are drawn uniformly (with replacement) from the client's true
    partition, keyed by ``determinism.batch_key(round_key, client)``, so the
    batch stream of a (seed, round, client) is the same however rounds or
    async events are chunked. Bitwise lane ``client`` of
    ``gather_client_batches``: the draw is counter-based, one value per
    (key, step, slot). Returns {"x": (n_steps, B, ...), "y": (n_steps, B)}.
    """
    key = determinism.batch_key(round_key, client)
    pos = _positions(key, staged["len"][client], n_steps, batch_size)
    # (``round_key`` and ``client`` may be 0-d int64 tensors: an async
    # campaign lane's, under the vmap over lanes)
    sel = staged["idx"][client][pos]
    return {"x": staged["x"][sel], "y": staged["y"][sel]}


def gather_client_batches(staged, round_key: int, batch_size: int,
                          n_steps: int) -> dict:
    """Per-round batch gather for every client, on the staged device: the
    lanes of ``gather_one_client_batch``, drawn in one vectorised pass.
    Returns {"x": (C, n_steps, B, ...), "y": (C, n_steps, B)}.
    """
    idx, lens = staged["idx"], staged["len"]
    C = idx.shape[0]
    keys = determinism.batch_keys(round_key, C, idx.device)
    pos = _positions(keys[:, None], lens[:, None], n_steps, batch_size)
    sel = torch.gather(idx, 1, pos.reshape(C, -1)).reshape(pos.shape)
    return {"x": staged["x"][sel], "y": staged["y"][sel]}


@dataclasses.dataclass
class SyntheticVision:
    """Deterministic synthetic image classification dataset family."""
    n_items: int = 2048
    shape: tuple = (32, 32, 3)
    n_classes: int = 10
    seed: int = 0
    noise: float = 0.8

    def prepare_root_dataset(self):
        """Generate the root ``(x, y)`` arrays for the configured size."""
        rng = np.random.RandomState(self.seed)
        y = rng.randint(0, self.n_classes, self.n_items)
        protos = rng.randn(self.n_classes, *self.shape).astype(np.float32)
        x = protos[y] + self.noise * rng.randn(
            self.n_items, *self.shape).astype(np.float32)
        return x, y

    def distribute_into_chunks(self, kind: str, n_clients: int,
                               alpha: float = 0.5):
        """Partition the root set; returns ``(x, y, per-client index lists)``."""
        x, y = self.prepare_root_dataset()
        parts = part_mod.partition(kind, y, n_clients, alpha, self.seed)
        return x, y, parts

    @staticmethod
    def client_batches(x, y, idx, batch_size: int, n_steps: int, seed: int,
                       cursor: int = 0):
        """Deterministic host batches for one client (numpy, the JAX
        package's draw): a seeded permutation of ``idx`` repeated as a
        stream, ``n_steps`` batches read from ``cursor``. Returns
        ``({"x": (n_steps, B, ...), "y": (n_steps, B)}, new cursor)``."""
        rng = np.random.RandomState(seed)
        order = idx[rng.permutation(len(idx))]
        reps = int(np.ceil((cursor + n_steps * batch_size) / max(len(order), 1)))
        stream = np.concatenate([order] * max(reps, 1))
        sel = stream[cursor:cursor + n_steps * batch_size]
        sel = sel.reshape(n_steps, batch_size)
        return {"x": x[sel], "y": y[sel]}, cursor + n_steps * batch_size
