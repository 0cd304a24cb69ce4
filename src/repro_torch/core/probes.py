"""Round probes (port of ``repro/core/probes.py``): read-only per-round
diagnostics computed inside the round loops, and the append-only tables
they and the comms plane land in.

The catalogue (every probe is one f32 scalar per round, per campaign lane):

==================  ========================================================
``update_norm``     L2 norm of the server parameter change this round
                    (async: this event, 0 for a buffered non-apply event).
``drift_norm``      sync: weighted std of the client deltas around their
                    aggregate, sqrt(E_w||d_c||^2 - ||E_w d_c||^2)
                    (decentralized: the spread of the client models);
                    async: ||stale snapshot - server params||.
``participation``   sync: cohort clients with nonzero weight this round;
                    async: 1 if the arrival was accepted.
``masked_frac``     fraction of the client weight mass excluded this round
                    (async: 1 - accept).
``sat_frac``        int8 path: fraction of the sends saturated at +-127.
``ef_residual_norm``  int8 spatial path: RMS over the cohort of the
                    error-feedback residual norm; 0 without residuals.
``nonfinite``       1.0 when any parameter is NaN/Inf after the update.
==================  ========================================================

Probes only add consumers of values the round already computes, so a run
with them is bitwise the run without (``tests/test_torch_probes.py``); a
dead campaign lane emits zeros. ``on_divergence: freeze`` holds a lane at
its last finite state through ``rounds.freeze_unless``.

The whole-model helpers compute through the round's view of the model
(``shards``, ``core/treeview``): on the temporal placement's mesh every
tree is a rank's shards and its ``sharding/specs.TreeShards`` gives the
whole model's norm or fraction, each element counted once and the same on
every rank (the JAX package ``pmean``s the ranks' shard norms: ROADMAP C13).
"""
from __future__ import annotations

import csv
import dataclasses
import pathlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.core.treeview import WHOLE, WholeTree

# the fixed catalogue: the P axis of a launch's (R, P) / (S, R, P) probe
# plane; probes.csv columns and counter names follow this order
PROBE_NAMES = ("update_norm", "drift_norm", "participation", "masked_frac",
               "sat_frac", "ef_residual_norm", "nonfinite")

# async per-event -> per-round reduction (rounds are fixed event windows,
# so the stream is the same for every chunking); unlisted probes: mean
ASYNC_REDUCE = {"update_norm": "max", "participation": "sum",
                "nonfinite": "max"}

_ON_DIVERGENCE = ("report", "freeze")


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """Parsed ``probes:`` job section (validated by ``core/jobs.load_job``).

    ``enabled`` adds the probe outputs to the round loops; ``out_dir``
    receives ``probes.csv`` (else the telemetry out_dir, then the
    executor's); ``on_divergence``: ``report`` only emits the sentinel,
    ``freeze`` holds a lane at its last finite state."""
    enabled: bool = False
    out_dir: Optional[str] = None
    on_divergence: str = "report"

    def __post_init__(self):
        if self.on_divergence not in _ON_DIVERGENCE:
            raise ValueError(
                f"probes.on_divergence must be one of {_ON_DIVERGENCE}, "
                f"got {self.on_divergence!r}")
        if self.on_divergence == "freeze" and not self.enabled:
            raise ValueError(
                "probes.on_divergence: freeze needs probes.enabled: true "
                "(the sentinel that drives the freeze is a probe)")

    @property
    def freeze(self) -> bool:
        """True when a diverged lane is held at its last finite state."""
        return self.enabled and self.on_divergence == "freeze"

    @classmethod
    def from_job(cls, job) -> "ProbeSpec":
        """Build from a job's ``probes:`` section (absent -> disabled)."""
        p = (getattr(job, "raw", None) or {}).get("probes") or {}
        return cls(enabled=bool(p) and bool(p.get("enabled", True)),
                   out_dir=p.get("out_dir"),
                   on_divergence=p.get("on_divergence", "report"))


# -- in-round arithmetic: each helper only reads what the round computed ----

def _leaves(tree):
    """Tensor leaves in the JAX package's flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def tree_sq_norm(tree: dict, shards: WholeTree = WHOLE):
    """Sum of squares over every leaf of a flat dict, accumulated in f32,
    of the whole tree ``shards`` views."""
    return shards.sq_norm(tree)


def tree_norm(tree: dict, shards: WholeTree = WHOLE):
    """Global L2 norm over a flat dict's leaves (``shards`` as
    ``tree_sq_norm``)."""
    return torch.sqrt(tree_sq_norm(tree, shards))


def tree_nonfinite(tree):
    """1.0 when any leaf holds a NaN/Inf, else 0.0."""
    bad = [(~torch.isfinite(leaf.to(torch.float32))).any()
           for leaf in _leaves(tree)]
    if not bad:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack(bad).any().to(torch.float32)


def stack_probes(pr: dict):
    """Probe dict -> one ``(P,)`` f32 vector in ``PROBE_NAMES`` order."""
    return torch.stack([torch.as_tensor(pr[name]).to(torch.float32)
                        for name in PROBE_NAMES])


def norm_nonfinite(norm):
    """The sentinel read off the update norm: a NaN/Inf in the new params
    makes the (new - old) delta, and so its norm, nonfinite."""
    return (~torch.isfinite(norm)).to(torch.float32)


def per_client_sq_norms(deltas):
    """(C,) sum of squares per client of a tree stacked on a leading C."""
    total = None
    for leaf in _leaves(deltas):
        sq = torch.square(leaf.to(torch.float32)).reshape(leaf.shape[0], -1).sum(-1)
        total = sq if total is None else total + sq
    return total


def _packed_leaves(template, q) -> dict:
    """The leaves packed into ``q``'s rows (``packing``'s layout; None: the
    rows are one leaf)."""
    return {"": torch.empty(q.shape[-1], device="meta")} if template is None else template


def packed_sq_norms(q, scale, template: dict | None = None, shards: WholeTree = WHOLE):
    """(C,) sum of squares of dequantized ``(C, N) int8`` sends, blockwise
    from the scales (no (C, N) f32 dequant), over the whole tree that
    ``shards`` views: each row packs ``template``'s leaves (on a mesh a
    rank's shards), each leaf's blocks summed, then the leaves."""
    c, n = q.shape
    nb = scale.shape[-1]
    qb = n // nb
    blocks = torch.square(q.to(torch.float32)).reshape(c, nb, qb).sum(-1) \
        * torch.square(scale)
    spans = packing.leaf_spans(_packed_leaves(template, q), qb)
    return shards.total({k: blocks[:, a // qb:b // qb].sum(-1) for k, (a, b) in spans.items()})


def packed_sq_norm(q, scale):
    """Sum of squares of one dequantized ``(N,) int8`` send."""
    nb = scale.shape[-1]
    qsq = torch.square(q.to(torch.float32)).reshape(nb, -1).sum(-1)
    return (qsq * torch.square(scale)).sum()


def sat_frac(q, template: dict | None = None, shards: WholeTree = WHOLE):
    """Fraction of int8 values saturated at the +-127 clip points, over the
    sends of the whole tree that ``shards`` views: the rows of ``q`` pack
    ``template``'s leaves (``packed_sq_norms``); the saturated count over
    the rows times the whole tree's packed size (pads are zero, never
    saturated)."""
    leaves = _packed_leaves(template, q)
    sat = (torch.abs(q.to(torch.int32)) >= 127).to(torch.float32)
    count = shards.total({k: sat[..., a:b].sum()
                          for k, (a, b) in packing.leaf_spans(leaves).items()})
    whole = {k: torch.empty(shards.whole_shape(k, t.shape), device="meta")
             for k, t in leaves.items()}
    n = sat[..., 0].numel() * packing.packed_size(whole)[0]
    return count / torch.full((), float(n), device=q.device)


def drift_from_moments(weights, per_client_sq, agg_sq, psum=lambda x: x):
    """sqrt(E_w ||d_c||^2 - ||agg||^2), clipped at 0: the weighted std of
    the client deltas around their aggregate (variance identity); ``psum``
    folds the client shards of a mesh's ranks."""
    wsum = psum(weights.sum())
    mean_sq = psum((weights * per_client_sq).sum()) / torch.clamp(wsum, min=1e-12)
    return torch.sqrt(torch.clamp(mean_sq - agg_sq, min=0.0))


def mask_probes(alive, pr: dict) -> dict:
    """A dead lane's probes read 0 (``alive``: the lane's 0/1 mask)."""
    keep = alive > 0
    return {k: torch.where(keep, v, torch.zeros_like(v)) for k, v in pr.items()}


# -- host-side async extras (functions of the schedule alone) --------------

def buffer_occupancy(accept, apply) -> np.ndarray:
    """(E,) accepted-not-yet-applied arrivals after each event (an apply
    event's occupancy reads 0: the arrival is written, then flushed)."""
    accept = np.asarray(accept).astype(np.int64)
    apply = np.asarray(apply).astype(bool)
    occ = np.empty(len(accept), np.int64)
    run = 0
    for i in range(len(accept)):
        run += accept[i]
        if apply[i]:
            run = 0
        occ[i] = run
    return occ


def staleness_hist(staleness, max_staleness: int) -> dict:
    """Counter values ``{"s0": n0, ...}`` of a window's staleness (the last
    bucket takes everything >= max_staleness)."""
    s = np.clip(np.asarray(staleness).astype(np.int64).ravel(), 0,
                max_staleness)
    counts = np.bincount(s, minlength=max_staleness + 1)
    return {f"s{i}": int(c) for i, c in enumerate(counts)}


# -- probes.csv / comms.csv --------------------------------------------------

class ProbeTable:
    """Append-only csv writer (one row per (lane,) round): ``probes.csv``
    and ``comms.csv``.

    The column set is fixed, so columns never grow: the file truncates on
    the first flush of a process (one file per run) and every later flush
    appends only the new rows."""

    def __init__(self, path, lead):
        self.path = pathlib.Path(path)
        self.lead = list(lead)
        self._fieldnames = None
        self._fh = None
        self._writer = None

    def flush(self, rows) -> Optional[pathlib.Path]:
        """Append ``rows`` (the new rows only — the caller buffers). The
        file handle stays open across flushes (a boundary-per-round run
        would otherwise pay an open/close per round); every flush ends on
        a flushed handle, so the csv is readable mid-run."""
        if not rows:
            return self.path if self._fieldnames else None
        if self._fieldnames is None:
            self._fieldnames = self.lead + sorted(
                {k for r in rows for k in r} - set(self.lead))
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._open("w")
            self._writer.writeheader()
        elif self._fh is None:                 # flushed again after close()
            self._open("a")
        self._writer.writerows(rows)
        self._fh.flush()
        return self.path

    def _open(self, mode: str):
        self._fh = open(self.path, mode, newline="")
        self._writer = csv.DictWriter(self._fh, fieldnames=self._fieldnames)

    def close(self) -> None:
        """Close the file handle; a later ``flush`` appends again."""
        if self._fh is not None:
            self._fh.close()
            self._fh = self._writer = None


def read_probes(csv_path) -> list:
    """Read a ``probes.csv`` back into tidy rows (floats where numeric,
    ints for round/traj, categorical coordinates as strings)."""
    def cell(k, v):
        if k in ("round", "traj", "seed", "bucket", "lane"):
            return int(float(v))
        try:
            return float(v)
        except ValueError:
            return v
    with open(csv_path, newline="") as f:
        return [{k: cell(k, v) for k, v in row.items() if v != ""}
                for row in csv.DictReader(f)]
