"""Deterministic synthetic data, device-resident staging and the
streaming client plane (port of ``repro/data/pipeline.py``).

``SyntheticVision``, ``SyntheticPopulation`` and ``SyntheticLM`` are the
same numpy ``RandomState`` generators as the JAX package's, so root data,
shards and token streams are bitwise equal. Resident staging puts the
whole root set and the padded partition index matrix on the device once;
every round then gathers its batches there with no host round-trip.

The ragged client plane (``max_cohort > 0``) stages per chunk instead: a
slab stager replays the cohort draw on the host and hands each chunk a
*slab* of the sampled cohorts' shards, padded to K = max_cohort slots.
``ResidentSlabStager`` gathers it on the device from a staged root;
``StreamingSlabStager`` never stages the population: only the sampled
shards leave host memory. Its double buffer is built for eager execution,
where the host is busy issuing the current chunk's kernels until the chunk
ends: a background thread assembles the next chunk's slab straight into a
pinned host buffer (two per slab layout, reused in turn, each rewritten
only after its last copy completed), the host-to-device copy runs on a
side CUDA stream, and the main stream waits on the copy's event before the
chunk reads the slab (which takes ``record_stream`` on it). On the CPU the
same code runs with plain buffers and no stream. Both stagers feed the same
bytes to the same round, so streaming == resident bitwise.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time

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


def stage_partitions_stacked(trajectories, device) -> dict:
    """Stage S trajectories' ``(x, y, parts)`` as one stacked residency:
    every leaf of ``stage_partitions`` with a leading S (roots duplicated
    where lanes share them; ``stage_partitions_dedup`` shares them).

      x (S, N, ...) f32   y (S, N) int64   idx (S, C, Lmax) int64   len (S, C)

    All trajectories share n_items and n_clients. Lmax is the widest
    trajectory's; gather positions stay in [0, len), so the wider pad is
    never read and lane s gathers what its own staging gathers."""
    if len({len(parts) for _, _, parts in trajectories}) != 1:
        raise ValueError("trajectories disagree on n_clients")
    lmax = max(max((max((len(p) for p in parts), default=1), 1)
                   for _, _, parts in trajectories))
    return {
        "x": torch.as_tensor(np.stack([np.asarray(x, np.float32)
                                       for x, _, _ in trajectories]), device=device),
        "y": torch.as_tensor(np.stack([np.asarray(y, np.int64)
                                       for _, y, _ in trajectories]), device=device),
        "idx": torch.as_tensor(np.stack([_pad_idx(parts, lmax).astype(np.int64)
                                         for _, _, parts in trajectories]), device=device),
        "len": torch.as_tensor(np.stack([np.asarray([len(p) for p in parts], np.int64)
                                         for _, _, parts in trajectories]), device=device)}


# a campaign's staged planes: the concatenated roots are shared by every
# lane, the partition index and sizes carry the lane dim (the vmap dims of
# ``core/rounds.DEDUP_STAGED_DIMS``)
DEDUP_STAGED_AXES = {"x": None, "y": None, "idx": 0, "len": 0}


def stage_partitions_dedup(trajectories, keys, device, mesh=None):
    """Stage S trajectories' ``(x, y, parts)`` with the root datasets
    deduplicated: lanes with equal ``keys`` (the campaign's (seed,
    partition, alpha)) share ONE device copy. The unique roots are
    concatenated along the item axis and each lane's padded index matrix
    is offset into the concatenation, so a lane's gather reads the bytes
    its single run reads. Returns ``(staged, lane_ds)``:

      x ((sum_u N_u), ...) f32   y ((sum_u N_u),) int64   shared roots
      idx (S, C, Lmax) int64     len (S, C) int64         per lane

    and ``lane_ds`` (S,) int, each lane's unique root.

    ``mesh`` (a ``launch/mesh.lane_mesh``) places the staging for a
    device-parallel campaign by ``DEDUP_STAGED_AXES``: the concatenated
    roots whole on every rank, the ``idx``/``len`` planes cut to the rank's
    block of lanes (S must then split over the mesh: the campaign pads it
    with dead lanes first)."""
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
    staged = {"x": np.concatenate([np.asarray(x, np.float32) for x, _, _ in roots]),
              "y": np.concatenate([np.asarray(y, np.int64) for _, y, _ in roots]),
              "idx": np.stack([pads[u] for u in lane_ds]),
              "len": np.stack([lens[u] for u in lane_ds])}
    if mesh is not None:
        from repro_torch.launch.mesh import shard_lanes
        staged = shard_lanes(staged, mesh, DEDUP_STAGED_AXES)
    return {k: torch.as_tensor(v, device=device) for k, v in staged.items()}, lane_ds


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


# -- the ragged client plane: cohort slabs and their stagers ------------------
#
# A slab for a chunk of n rounds starting at absolute round ``start`` holds,
# with a leading round dim n:
#
#   x   (n, K, Lmax, ...) f32 slot features   y   (n, K, Lmax) int64 labels
#   len (n, K) int64 true shard sizes         cid (n, K) int64 real client ids
#   w   (n, K) f32 FedAvg base weight (len) times the cohort mask, 0 on pads
#
# Kept clients fill the slots in ascending id order; pad slots repeat the
# first kept client's shard (zero weight, harmless to train on). An async
# event slab holds one row per event: x (E, Lmax, ...), y (E, Lmax), len (E,).


def slab_nbytes(slab) -> int:
    """Total bytes of a slab's tensors (or numpy arrays)."""
    return int(sum(t.numel() * t.element_size() if isinstance(t, torch.Tensor)
                   else t.nbytes for t in slab.values()))


def gather_slab_batches(slab_row, round_key, batch_size: int, n_steps: int) -> dict:
    """One round's batches from a slab row, on the slab's device: slot k
    draws its positions in [0, len[k]) keyed by
    ``determinism.batch_key(round_key, cid[k])``, the *real* client id, so a
    slot's batch is bitwise the dense ``gather_one_client_batch`` of that
    client, whatever its slot and the slab's pad width. Returns
    {"x": (K, n_steps, B, ...), "y": (K, n_steps, B)}."""
    keys = determinism.fold_in_tensor(determinism.fold_in(round_key, 0xBA7C),
                                      slab_row["cid"])
    pos = _positions(keys[:, None], slab_row["len"][:, None], n_steps, batch_size)
    slot = torch.arange(pos.shape[0], device=pos.device).reshape(-1, 1, 1)
    return {"x": slab_row["x"][slot, pos], "y": slab_row["y"][slot, pos]}


def gather_event_batch(row, round_key, client: int, batch_size: int,
                       n_steps: int) -> dict:
    """One async event's batches from its slab row (x (Lmax, ...), y, len),
    with ``gather_one_client_batch``'s draw keyed by the schedule's client:
    bitwise the dense gather. Returns {"x": (n_steps, B, ...), "y": ...}."""
    key = determinism.batch_key(round_key, client)
    pos = _positions(key, row["len"], n_steps, batch_size)
    return {"x": row["x"][pos], "y": row["y"][pos]}


class Slab(dict):
    """A staged slab: its tensors by name, ``ready`` (the CUDA event its
    host-to-device copy records; None where no copy is in flight) and
    ``stats`` (host seconds and bytes of its staging, the copy's events)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.ready = None
        self.stats = {}


class _HostSlabs:
    """Host buffers of the streaming stagers: two per slab layout, reused
    in turn, pinned where the slab goes to a CUDA device. A buffer is
    handed out only after the copy that last read it has completed, and
    ``upload`` copies one to the device on a side stream. On the CPU the
    buffers are plain and ``upload`` is a copy."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self._pairs = {}        # layout -> [buffer, buffer]
        self._turn = {}         # layout -> index of the next buffer
        self._copied = {}       # id(buffer) -> the event of its last copy
        self._stream = None
        self._lock = threading.Lock()

    def take(self, layout) -> dict:
        """A buffer of ``layout`` ((name, shape, torch dtype), ...) whose
        last copy has completed: {name: host tensor}."""
        with self._lock:
            pair = self._pairs.setdefault(layout, [None, None])
            i = self._turn.get(layout, 0)
            self._turn[layout] = 1 - i
            if pair[i] is None:
                pair[i] = {name: torch.empty(shape, dtype=dtype, pin_memory=self.cuda)
                           for name, shape, dtype in layout}
            buf = pair[i]
            copied = self._copied.pop(id(buf), None)
        if copied is not None:
            copied.synchronize()
        return buf

    def upload(self, buf) -> Slab:
        """``buf`` on the device. CUDA: non-blocking copies on the side
        stream between two timing events; the slab's ``ready`` is the
        second, which also frees ``buf`` for its next ``take``."""
        if not self.cuda:
            return Slab({k: t.clone() for k, t in buf.items()})
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            with torch.cuda.stream(self._stream):
                start.record()
                slab = Slab({k: t.to(self.device, non_blocking=True)
                             for k, t in buf.items()})
                end.record()
        with self._lock:
            self._copied[id(buf)] = end
        slab.ready = end
        slab.stats["h2d_events"] = (start, end)
        return slab


class _Prefetcher:
    """Single-slot double buffer: one background thread stages the next
    chunk's slab while the device runs the current one. A request that does
    not match the pending prefetch (a resume, a horizon that changed) waits
    for that prefetch to finish (one writer of the host buffers at a time)
    and assembles synchronously.

    ``stats`` keeps one record per slab taken: ``prefetched``, ``take_s``
    (the caller's seconds to get it), ``plan_s`` (the host cohort draw),
    ``fill_s`` (host assembly; ``shard_s`` of it in shard factories),
    ``bytes``, and ``h2d_events`` (the side-stream copy's timing events;
    ``chunk_stats`` turns them into ``h2d_ms``)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.peak_slab_bytes = 0
        self.stats = []
        self._host = _HostSlabs(self.device)
        self._pool = None
        self._pending = None

    def _submit(self, key, fn):
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="slab-stager")
        self._pending = (key, self._pool.submit(fn))

    def _take(self, key, fn) -> Slab:
        pend, self._pending = self._pending, None
        t0 = time.perf_counter()
        hit = pend is not None and pend[0] == key
        if hit:
            slab = pend[1].result()
        else:
            if pend is not None:
                pend[1].result()
            slab = fn()
        take_s = time.perf_counter() - t0
        if slab.ready is not None:
            # order the side stream's copy before the chunk's kernels, and
            # keep the slab's memory from the side stream's reuse until the
            # main stream is done with it
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(slab.ready)
            for t in slab.values():
                t.record_stream(stream)
            slab.ready = None
        nbytes = slab_nbytes(slab)
        self.peak_slab_bytes = max(self.peak_slab_bytes, nbytes)
        self.stats.append(dict(slab.stats, key=key, prefetched=hit, take_s=take_s,
                               bytes=nbytes))
        return slab

    def chunk_stats(self) -> list:
        """``stats`` with each copy's device milliseconds (``h2d_ms``, None
        where there was no copy) in place of its events."""
        out = []
        for rec in self.stats:
            rec = dict(rec)
            ev = rec.pop("h2d_events", None)
            if ev is not None:
                ev[1].synchronize()
                rec["h2d_ms"] = ev[0].elapsed_time(ev[1])
            else:
                rec["h2d_ms"] = None
            out.append(rec)
        return out


class SlabStager(_Prefetcher):
    """Host cohort planning shared by the resident and streaming stagers.
    ``plan`` replays ``runtime.faults.select_cohort``, the host view of the
    cohort mask the dense round draws."""

    def __init__(self, fl, fault, device):
        super().__init__(device)
        from repro_torch.runtime.faults import FaultModel
        self.fl = fl
        self.fault = fault if fault is not None else FaultModel()
        self.k_slots = int(fl.max_cohort)
        self.lmax = 1
        self.lens = np.zeros((fl.n_clients,), np.int64)

    def plan(self, start: int, n: int):
        """The cohorts of rounds [start, start + n) on the host: slots (n,
        K) int64 (kept clients ascending, pads repeating the first) and real
        (n, K) f32 (1 on kept slots)."""
        from repro_torch.runtime.faults import select_cohort
        fl = self.fl
        target = int(fl.cohort or fl.n_clients)
        ids = np.arange(fl.n_clients)
        slots = np.zeros((n, self.k_slots), np.int64)
        real = np.zeros((n, self.k_slots), np.float32)
        for i in range(n):
            kept = select_cohort(self.fault, start + i, ids, target,
                                 fl.straggler_overprovision)
            if len(kept) > self.k_slots:
                raise ValueError(f"round {start + i} kept {len(kept)} clients but "
                                 f"max_cohort={self.k_slots} slots are staged")
            slots[i] = kept[0] if len(kept) else 0
            slots[i, :len(kept)] = kept
            real[i, :len(kept)] = 1.0
        return slots, real

    def widen(self, lmax: int) -> None:
        """Pad shards to a wider Lmax (campaign lanes share one width)."""
        self.lmax = max(self.lmax, int(lmax))

    def slab(self, start: int, n: int) -> Slab:
        """The chunk's slab, ready for the current stream (from the
        prefetch if it was the one asked for)."""
        return self._take(("sync", start, n), lambda: self._assemble_chunk(start, n))

    def prefetch(self, start: int, n: int) -> None:
        """Stage the chunk [start, start + n) in the background."""
        if n > 0:
            self._submit(("sync", start, n), lambda: self._assemble_chunk(start, n))

    def event_slab(self, clients, tag) -> Slab:
        """The async event rows of ``clients`` (one per event); ``tag``
        names the event window in the prefetch slot."""
        clients = np.asarray(clients, np.int64)
        return self._take(("ev", tag), lambda: self._assemble_events(clients))

    def prefetch_events(self, clients, tag) -> None:
        """Stage the next event window's rows in the background."""
        clients = np.asarray(clients, np.int64)
        if len(clients):
            self._submit(("ev", tag), lambda: self._assemble_events(clients))

    def _assemble_chunk(self, start: int, n: int) -> Slab:
        t0 = time.perf_counter()
        slots, real = self.plan(start, n)
        plan_s = time.perf_counter() - t0
        slab = self._assemble(slots, real)
        slab.stats["plan_s"] = plan_s
        return slab


class ResidentSlabStager(SlabStager):
    """Slab stager over a root staged on the device once: a chunk's slab is
    one device gather, queued like any kernel, so nothing is prefetched."""

    def __init__(self, x, y, parts, fl, fault, device):
        super().__init__(fl, fault, device)
        self._parts = parts
        self.staged = stage_partitions(x, y, parts, self.device)
        self.lmax = int(self.staged["idx"].shape[1])
        self.lens = np.asarray([len(p) for p in parts], np.int64)
        self.data = (x, y, parts)
        self.resident_bytes = slab_nbytes(self.staged)
        self.device_bytes = self.resident_bytes

    def widen(self, lmax: int) -> None:
        """Re-pad the staged index plane to a wider Lmax."""
        if int(lmax) > self.lmax:
            self.lmax = int(lmax)
            self.staged["idx"] = torch.as_tensor(
                _pad_idx(self._parts, self.lmax).astype(np.int64), device=self.device)

    def prefetch(self, start: int, n: int) -> None:
        """Nothing to stage ahead: ``slab`` only queues device work."""

    def prefetch_events(self, clients, tag) -> None:
        """Nothing to stage ahead: ``event_slab`` only queues device work."""

    def _assemble(self, slots, real) -> Slab:
        t0 = time.perf_counter()
        sl = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        idx = self.staged["idx"][sl]                         # (n, K, Lmax)
        lens = self.staged["len"][sl]
        slab = Slab(x=self.staged["x"][idx], y=self.staged["y"][idx], len=lens,
                    cid=sl, w=lens.to(torch.float32)
                    * torch.as_tensor(np.asarray(real, np.float32), device=self.device))
        slab.stats["fill_s"] = time.perf_counter() - t0
        return slab

    def _assemble_events(self, clients) -> Slab:
        cl = torch.as_tensor(np.asarray(clients, np.int64), device=self.device)
        idx = self.staged["idx"][cl]                         # (E, Lmax)
        return Slab(x=self.staged["x"][idx], y=self.staged["y"][idx],
                    len=self.staged["len"][cl])


class StreamingSlabStager(SlabStager):
    """Slab stager that never stages the population: only the sampled
    cohorts' shards are gathered on the host and copied to the device,
    double-buffered by the inherited prefetch thread.

    ``shard_fn(cid) -> (x_c (l, ...), y_c (l,))`` must be deterministic; a
    ``SyntheticPopulation`` generates shards on demand, and
    ``from_partitions`` streams an in-memory root (bitwise the resident
    stager's slabs)."""

    def __init__(self, shard_fn, fl, fault, lens, device, lmax=None):
        super().__init__(fl, fault, device)
        self._shard = shard_fn
        self.lens = np.asarray(lens, np.int64)
        if len(self.lens) != fl.n_clients:
            raise ValueError(f"{len(self.lens)} shard lengths for "
                             f"n_clients={fl.n_clients}")
        self.lmax = int(lmax) if lmax else max(int(self.lens.max()), 1)
        x0, y0 = (np.asarray(a) for a in shard_fn(0))
        self._item_shape = x0.shape[1:]
        self._x_dtype, self._y_dtype = x0.dtype, y0.dtype
        item = int(np.prod(self._item_shape, dtype=np.int64))
        # what full residency would cost, the reference's formula: shards
        # padded to Lmax with their labels, plus the int32 index and length
        # planes of the JAX package's staging
        c = int(fl.n_clients)
        self.resident_bytes = int(c * self.lmax * (item * self._x_dtype.itemsize
                                                   + self._y_dtype.itemsize + 4) + c * 4)
        self.device_bytes = 0
        self._root = None       # (x, y, parts) of an in-memory root

    @classmethod
    def from_partitions(cls, x, y, parts, fl, fault, device):
        """Streaming view of an in-memory root: shard c is x[parts[c]]; an
        empty partition reads root item 0, as the resident staging's zero
        index rows do."""
        x, y = np.asarray(x, np.float32), np.asarray(y, np.int64)

        def shard(c):
            p = np.asarray(parts[c], np.int64)
            return (x[p], y[p]) if len(p) else (x[:1], y[:1])

        lens = np.asarray([len(p) for p in parts], np.int64)
        st = cls(shard, fl, fault, lens=lens, device=device)
        st._root = (x, y, parts)
        st.data = (x, y, parts)
        return st

    def _rows(self, length: int) -> np.ndarray:
        """A shard's rows cycled to Lmax."""
        return np.arange(self.lmax, dtype=np.int64) % max(length, 1)

    def _fill_client(self, c: int, out_x, out_y, cache, timer) -> None:
        """Client ``c``'s padded shard into ``out_x`` (Lmax, ...) and
        ``out_y`` (Lmax,), host views of the slab buffer."""
        if self._root is not None:
            x, y, parts = self._root
            p = np.asarray(parts[c], np.int64)
            rows = p[self._rows(len(p))] if len(p) else np.zeros(self.lmax, np.int64)
            np.take(x, rows, axis=0, out=out_x, mode="clip")
            np.take(y, rows, out=out_y, mode="clip")
            return
        if c not in cache:
            t0 = time.perf_counter()
            cache[c] = tuple(np.asarray(a) for a in self._shard(c))
            timer[0] += time.perf_counter() - t0
        xc, yc = cache[c]
        rows = self._rows(len(yc))
        out_x[...] = xc[rows]
        out_y[...] = yc[rows]

    def _layout(self, lead) -> tuple:
        return (("x", tuple(lead) + (self.lmax,) + self._item_shape, torch.float32),
                ("y", tuple(lead) + (self.lmax,), torch.int64),
                ("len", tuple(lead), torch.int64),
                ("cid", tuple(lead), torch.int64),
                ("w", tuple(lead), torch.float32))

    def _fill_slab(self, slots, real, out) -> float:
        """The slab of ``(slots, real)`` into the numpy views ``out``;
        returns the seconds spent in ``shard_fn``."""
        timer, cache = [0.0], {}
        n, k = slots.shape
        for i in range(n):
            for j in range(k):
                self._fill_client(int(slots[i, j]), out["x"][i, j], out["y"][i, j],
                                  cache, timer)
        out["len"][...] = self.lens[slots]
        out["cid"][...] = slots
        out["w"][...] = self.lens[slots].astype(np.float32) * real
        return timer[0]

    def _assemble(self, slots, real) -> Slab:
        t0 = time.perf_counter()
        buf = self._host.take(self._layout(slots.shape))
        shard_s = self._fill_slab(slots, real, {k: t.numpy() for k, t in buf.items()})
        fill_s = time.perf_counter() - t0
        slab = self._host.upload(buf)
        slab.stats.update(fill_s=fill_s, shard_s=shard_s)
        return slab

    def _assemble_events(self, clients) -> Slab:
        t0 = time.perf_counter()
        e = len(clients)
        layout = self._layout((e,))[:3]
        buf = self._host.take(layout)
        host = {k: t.numpy() for k, t in buf.items()}
        timer, cache = [0.0], {}
        for i, c in enumerate(clients):
            self._fill_client(int(c), host["x"][i], host["y"][i], cache, timer)
        host["len"][...] = self.lens[clients]
        fill_s = time.perf_counter() - t0
        slab = self._host.upload(buf)
        slab.stats.update(fill_s=fill_s, shard_s=timer[0])
        return slab


class StackedSlabStager(_Prefetcher):
    """A campaign's stager: one slab stager per lane, stacked to a leading
    (S,) lane dim. The lanes are widened to one Lmax up front (never read
    past a shard's length, so lane s trains as its single run). Streaming
    lanes fill one host buffer of the stacked layout and take one copy."""

    def __init__(self, lanes):
        super().__init__(lanes[0].device)
        self.lanes = list(lanes)
        self.lmax = max(ln.lmax for ln in self.lanes)
        for ln in self.lanes:
            ln.widen(self.lmax)
        self.streaming = any(isinstance(ln, StreamingSlabStager) for ln in self.lanes)
        self.resident_bytes = sum(ln.resident_bytes for ln in self.lanes)
        self.device_bytes = sum(ln.device_bytes for ln in self.lanes)

    def slab(self, start: int, n: int) -> Slab:
        """The chunk's stacked (S, n, K, ...) slab on the device."""
        return self._take(("sync", start, n), lambda: self._assemble_chunk(start, n))

    def prefetch(self, start: int, n: int) -> None:
        """Stage the next chunk of every streaming lane in the background."""
        if n > 0 and self.streaming:
            self._submit(("sync", start, n), lambda: self._assemble_chunk(start, n))

    def _assemble_chunk(self, start: int, n: int) -> Slab:
        t0 = time.perf_counter()
        plans = [ln.plan(start, n) for ln in self.lanes]
        plan_s = time.perf_counter() - t0
        if not self.streaming:
            lanes = [ln._assemble(*p) for ln, p in zip(self.lanes, plans)]
            slab = Slab({k: torch.stack([ln[k] for ln in lanes]) for k in lanes[0]})
            slab.stats.update(plan_s=plan_s, fill_s=time.perf_counter() - t0 - plan_s)
            return slab
        t1 = time.perf_counter()
        S, lane0 = len(self.lanes), self.lanes[0]
        buf = self._host.take(lane0._layout((S,) + plans[0][0].shape))
        host = {k: t.numpy() for k, t in buf.items()}
        shard_s = sum(ln._fill_slab(slots, real, {k: v[s] for k, v in host.items()})
                      for s, (ln, (slots, real)) in enumerate(zip(self.lanes, plans)))
        fill_s = time.perf_counter() - t1
        slab = self._host.upload(buf)
        slab.stats.update(plan_s=plan_s, fill_s=fill_s, shard_s=shard_s)
        return slab


def make_slab_stager(dataset, fl, fault, device):
    """The slab stager of a ragged job. A population with a ``shard(cid)``
    factory (``SyntheticPopulation``) is never materialized and needs
    ``streaming: true``; an in-memory root stages resident, or streams when
    asked."""
    if hasattr(dataset, "shard"):
        if not fl.streaming:
            raise ValueError(
                f"{type(dataset).__name__} generates shards on demand and "
                "cannot be staged resident — set streaming: true")
        if int(dataset.n_clients) != int(fl.n_clients):
            raise ValueError(f"dataset population ({dataset.n_clients}) != "
                             f"fl.n_clients ({fl.n_clients})")
        lens = np.full(fl.n_clients, int(dataset.items_per_client), np.int64)
        return StreamingSlabStager(dataset.shard, fl, fault, lens=lens, device=device)
    x, y, parts = dataset.distribute_into_chunks(fl.partition, fl.n_clients,
                                                 fl.dirichlet_alpha)
    if fl.streaming:
        return StreamingSlabStager.from_partitions(x, y, parts, fl, fault, device)
    return ResidentSlabStager(x, y, parts, fl, fault, device)


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic next-token LM dataset family (numpy; the
    LM training path, ``repro_torch.launch.train_fl_lm``)."""
    vocab: int = 512
    seed: int = 0

    def tokens(self, batch: int, seq: int, salt: int = 0):
        """Markov-ish token stream: next token depends on previous one.
        -> {"tokens", "labels"}: (batch, seq) int32, labels shifted by one."""
        rng = np.random.RandomState(self.seed + salt)
        trans = rng.permutation(self.vocab)
        toks = np.zeros((batch, seq + 1), np.int32)
        toks[:, 0] = rng.randint(0, self.vocab, batch)
        noise = rng.rand(batch, seq)
        rand_tok = rng.randint(0, self.vocab, (batch, seq))
        for t in range(seq):
            nxt = trans[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t] < 0.75, nxt, rand_tok[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def client_batches(self, client_id: int, n_steps: int, batch: int,
                       seq: int, round_idx: int = 0):
        """Return ``n_steps`` stacked token batches for one client-round."""
        out = [self.tokens(batch, seq, salt=client_id * 100003 + round_idx * 7 + s)
               for s in range(n_steps)]
        return {k: np.stack([o[k] for o in out]) for k in out[0]}


@dataclasses.dataclass
class SyntheticPopulation:
    """A large client population materialized one shard at a time:
    ``shard(cid)`` generates client ``cid``'s few items from (seed, cid)
    with ``SyntheticVision``'s planted class-prototype signal, so a
    population costs no host memory until a cohort is sampled."""

    n_clients: int = 100_000
    items_per_client: int = 8
    shape: tuple = (8, 8, 1)
    n_classes: int = 10
    seed: int = 0
    noise: float = 0.8

    def __post_init__(self):
        self._protos = None     # the class prototypes, built on first use

    def shard(self, cid: int):
        """Client ``cid``'s shard as (x (l, ...) f32, y (l,)) numpy arrays."""
        if self._protos is None:
            rng0 = np.random.RandomState(self.seed)
            self._protos = rng0.randn(self.n_classes, *self.shape).astype(np.float32)
        rng = np.random.RandomState(
            (1_000_003 * (self.seed + 1) + int(cid)) % (2 ** 31 - 1))
        y = rng.randint(0, self.n_classes, self.items_per_client)
        x = self._protos[y] + self.noise * rng.randn(
            self.items_per_client, *self.shape).astype(np.float32)
        return x.astype(np.float32), y


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
