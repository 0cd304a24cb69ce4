"""Campaign executor (port of ``repro/runtime/campaign.py``): S sweep
trajectories advanced together, one vmapped pass of device work per round.

``core/sweeps.py`` expands the job's ``sweep:`` section into S per-lane
configs, split into a data plane (unique root datasets staged once and
indexed per lane, ``data/pipeline.stage_partitions_dedup``), a schedule
plane (async schedules deduplicated and indexed per lane) and a scalar
plane (``(S,)`` device tensors bound per lane by ``rounds.bind_hyper``).
``CampaignExecutor`` runs the single run's round (``rounds.build_multi_round
(..., lanes=True)``) or event loop (``async_rounds.build_async_lanes``)
under ``torch.func.vmap`` over a leading lane dim of the state: every
per-lane value — root and round keys, scalars, the alive mask, the schedule
index — is a device tensor, and an int8 round reduces all lanes' sends in
ONE ``(S, C, N)`` launch of B1. The chunk loop, checkpoint, ledger, eval
and telemetry seams are the single-run ``Executor``'s.

One executor serves one *program signature* (``core/plan.py``);
heterogeneous sweeps go through the planner
(``runtime/scheduler.PlanExecutor``), which builds one executor per bucket
with the ``lanes`` override. The lane scheduler's ``alive`` mask reaches
the round as a runtime value: a dropped lane's state freezes
(``rounds.freeze_unless``), its rows stop landing in the results table and
its ledger blocks stop.

Ragged lanes (``max_cohort > 0``): one slab stager per distinct plan key,
stacked by ``data/pipeline.StackedSlabStager`` into a per-chunk slab with a
leading lane dim, which the ragged round (``rounds.build_ragged_multi(...,
lanes=True)``) maps over; sync only and meshless, as in the JAX package.

Device-parallel campaigns (``lane_devices = n``, or a ``MeshConfig`` whose
``lanes`` axis is n): the sweep axis over an n-rank lane mesh
(``launch/mesh.lane_mesh``), one process per rank (``launch/mesh.spawn``),
each building the same executor. S pads to ``S_pad``, a multiple of n, with
dead lanes (clones of the last config, ``alive = 0`` from launch 1), and
each rank runs its contiguous block of ``S_pad // n`` lanes: its own
staging (``stage_partitions_dedup(mesh=)``: the data roots whole, the
lanes' planes its block), state and one B1 launch a round over its lanes.
The round needs no collective. At each chunk boundary the ranks gather host
objects over the mesh's ``gloo`` group: the block's metrics and probes
(so every rank holds the whole results table, and a planner's lane
scheduler decides the same drops on every rank), eval and digests, and the
state to checkpoint. Rank 0 alone writes ``campaign.csv``, the journals
and the checkpoint, which holds the real lanes only (the one-process
layout), so a resume may use another device count: the real lanes come
from the file and the pad tail from the fresh scaffold.

Determinism contract (``tests/test_torch_sweeps.py``,
``tests/test_torch_plan.py``): lane ``s`` is bitwise an independent single
run of the s-th config — keys are splitmix64 of the same coordinates, the
offset gather reads the same bytes, the scalars are equal-valued tensors,
B1's lane s is bitwise its ``(C, N)`` launch, and the alive select is the
identity for live lanes. Chunked == unchunked holds under the lane dim, so
campaigns checkpoint and resume like single runs.

Results land in a tidy table keyed by sweep coordinates (one row per
trajectory per round): ``campaign.csv`` always (appended per chunk),
``campaign.parquet`` where pandas and pyarrow import.
"""
from __future__ import annotations

import csv
import dataclasses
import hashlib
import pathlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core import determinism, sweeps
from repro_torch.core.blockchain import param_digest
from repro_torch.core.jobs import check_ragged, make_dataset, make_fault, validate_cohort
from repro_torch.core.plan import program_signature
from repro_torch.core.probes import PROBE_NAMES, buffer_occupancy, staleness_hist
from repro_torch.core.rounds import build_multi_round, build_ragged_multi, init_state, \
    tree_map
from repro_torch.data.pipeline import (StackedSlabStager, make_slab_stager,
                                       stage_partitions_dedup)
from repro_torch.launch.mesh import (barrier, gather_objects, lane_block, lane_mesh,
                                     lane_rank, shard_lanes)
from repro_torch.runtime.executor import Executor, tree_nbytes
from repro_torch.telemetry import comms as comms_mod

_INT_COLS = ("seed", "traj", "round", "bucket", "lane", "async_buffer")


def _parse_cell(k: str, v: str):
    if k in _INT_COLS:
        return int(float(v))
    try:
        return float(v)
    except ValueError:
        return v                        # categorical coords stay strings


def read_results(csv_path) -> list:
    """Read a campaign.csv back into tidy rows (numbers where numeric,
    categorical coordinates as strings; blank cells dropped)."""
    with open(csv_path, newline="") as f:
        return [{k: _parse_cell(k, v) for k, v in row.items() if v != ""}
                for row in csv.DictReader(f)]


def table_columns(rows, lead) -> list:
    """The tidy table's column order: lead columns, then the rest sorted."""
    return list(lead) + sorted({k for r in rows for k in r} - set(lead))


def write_parquet(rows, lead, out_dir) -> Optional[pathlib.Path]:
    """``campaign.parquet`` next to the CSV where pandas and pyarrow import
    (the CSV is the portable artifact); returns its path, or None."""
    try:
        import pandas as pd
        import pyarrow  # noqa: F401
    except ImportError:
        return None
    path = pathlib.Path(out_dir) / "campaign.parquet"
    pd.DataFrame(rows, columns=table_columns(rows, lead)).to_parquet(path)
    return path


class AppendTable:
    """Append-only tidy CSV writer: a chunk appends only its new rows; a
    full rewrite happens only when the column set changes (the first flush,
    a resume re-adopting a prior table). ``appends``/``rewrites`` count
    both."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.appends = 0
        self.rewrites = 0
        self._fieldnames = None
        self._written = 0

    def reset(self):
        """Forget on-disk state (the next flush rewrites): the resume path."""
        self._fieldnames = None
        self._written = 0

    def flush(self, rows, lead):
        """Bring the CSV up to date with ``rows`` (lead columns first)."""
        new = rows[self._written:]
        self.path.parent.mkdir(parents=True, exist_ok=True)
        if self._fieldnames is not None and self.path.exists() and self._written:
            if not {k for r in new for k in r} - set(self._fieldnames):
                if new:
                    with open(self.path, "a", newline="") as f:
                        csv.DictWriter(f, fieldnames=self._fieldnames).writerows(new)
                    self.appends += 1
                self._written = len(rows)
                return self.path
        keys = table_columns(rows, lead)
        with open(self.path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
        self.rewrites += 1
        self._fieldnames = keys
        self._written = len(rows)
        return self.path


def lane_of(tree, s: int):
    """Lane ``s`` of a tree with a leading lane dim."""
    return tree_map(lambda t: t[s], tree)


def stack_lanes(trees):
    """The lanes' trees stacked on a new leading dim."""
    return tree_map(lambda *ts: torch.stack(ts), *trees)


@dataclasses.dataclass
class CampaignExecutor(Executor):
    """The Executor over the sweep axis: the same round, vmapped over lanes.

    ``job`` must carry a ``sweep:`` section, or the planner passes
    ``lanes=(coords, fls)`` (one signature bucket). ``eval_fn`` keeps the
    single-run signature ``params -> dict`` and is applied per lane.
    ``out_dir`` (if set) receives ``campaign.csv`` at every chunk boundary.
    ``lane_scheduling`` threads the alive mask into the rounds (the planner
    sets it when a lane scheduler is attached). ``lane_devices``: the lane
    mesh's rank count (or a ``MeshConfig``; 0 and ``MeshConfig()``'s
    ``lanes = 1`` keep the one-process campaign), see the module
    docstring."""
    out_dir: Optional[str] = None
    lanes: Optional[tuple] = None     # (coords, fls) bucket override
    parquet: bool = True              # planner buckets defer to the merge
    lane_scheduling: bool = False
    lane_devices: int = 0

    def __post_init__(self):
        if self.job.sweep is None:
            raise ValueError("CampaignExecutor needs a job with a sweep: "
                             "section (see core/sweeps.py for the axes)")
        self.spec = self.job.sweep
        if self.lanes is not None:
            self.coords, self.fls = list(self.lanes[0]), list(self.lanes[1])
        else:
            self.coords = self.spec.coords()
            self.fls = sweeps.expand(self.job.fl, self.spec)
        sigs = {program_signature(f, self.job.arch) for f in self.fls}
        sigs.add(program_signature(self.job.fl, self.job.arch))
        if len(sigs) > 1:
            raise ValueError(
                "CampaignExecutor lanes span multiple program signatures "
                f"({len(sigs)}); heterogeneous sweeps (categorical axes "
                f"{self.spec.categorical_names}) must go through the "
                "planner: runtime.scheduler.PlanExecutor")
        for fl_s in self.fls:
            validate_cohort(fl_s)
        check_ragged(self.job.raw, self.job.fl, self.job.strategy)
        self.S = len(self.fls)
        # a MeshConfig's `lanes` axis is a spelling of the count; its
        # lanes = 1 default means no lane axis, the one-process campaign
        if hasattr(self.lane_devices, "lanes"):
            self.lane_devices = (self.lane_devices.lanes
                                 if self.lane_devices.lanes > 1 else 0)
        self.lane_devices = int(self.lane_devices)
        if self.lane_devices and self.job.fl.max_cohort > 0:
            raise NotImplementedError(
                "ragged campaigns (max_cohort > 0) do not shard over a "
                "lane mesh yet: the stacked slab is restaged per chunk "
                "on the host, which would break the zero-collective "
                "lane-sharding contract. Use lane_devices=0")
        self.mesh = lane_mesh(self.lane_devices) if self.lane_devices else None
        # S padded to a multiple of the rank count with dead lanes, clones
        # of the last config (no extra staged bytes through the dedup)
        d = max(self.lane_devices, 1)
        self.S_pad = -(-self.S // d) * d
        self._fls_pad = list(self.fls) + [self.fls[-1]] * (self.S_pad - self.S)
        self.block = lane_block(self.mesh, self.S_pad)      # the lanes run here
        self._fls_local = self._fls_pad[self.block.start:self.block.stop]
        self._writer = lane_rank(self.mesh) == 0            # files: rank 0 only
        self.alive = np.ones(self.S_pad, np.float32)        # scheduler + pad mask
        self.alive[self.S:] = 0.0                           # pad lanes never run
        self._thread_alive = self.lane_scheduling or self.S_pad > self.S
        self.rank_round_s = []         # per launch: every rank's seconds for it
        self._alive_dev = None         # the mask on the device, per drop
        self.results = []              # tidy rows: coords + traj/round/metrics
        self._tail_rows = []           # (lane, row) of each lane's last round
        self._table = (AppendTable(pathlib.Path(self.out_dir) / "campaign.csv")
                       if self.out_dir and self._writer else None)
        super().__post_init__()
        if not self._writer:
            self.recorder.out_dir = None   # events in memory: rank 0 writes

    def _build_sync(self, spec):
        if self.ragged:
            return build_ragged_multi(
                self.job.model, self.job.strategy, self.job.fl,
                placement=self.placement, probes=spec.enabled,
                on_divergence=spec.on_divergence, lanes=True)
        return build_multi_round(
            self.job.model, self.job.strategy, self.job.fl,
            placement=self.placement, fault=self.job.fault, device=self.device,
            probes=spec.enabled, on_divergence=spec.on_divergence, lanes=True)

    def _build_async(self, spec):
        from repro_torch.core.async_rounds import build_async_lanes
        return build_async_lanes(self.job.model, self.job.strategy, self.job.fl,
                                 probes=spec.enabled,
                                 on_divergence=spec.on_divergence)

    # -- the lane scheduler's interface -----------------------------------
    def drop_lane(self, s: int):
        """Freeze lane ``s`` from the next launch on: the alive mask is a
        runtime input, so its state holds and it stops producing rows and
        ledger blocks."""
        if not self.lane_scheduling:
            raise RuntimeError("drop_lane needs lane_scheduling=True at "
                               "construction (the alive mask must reach the "
                               "round from the first launch)")
        self.alive[s] = 0.0
        self._alive_dev = None

    def alive_lanes(self):
        return [s for s in range(self.S) if self.alive[s] > 0]

    def _launch_hyper(self):
        """The scalar plane, plus this rank's block of the alive mask under a
        scheduler or with pad lanes."""
        if not self._thread_alive:
            return self.hyper
        if self._alive_dev is None:
            self._alive_dev = torch.as_tensor(
                self.alive[self.block.start:self.block.stop], device=self.device)
        return dict(self.hyper, alive=self._alive_dev)

    # -- the lane mesh's host gathers ------------------------------------------
    def _gather_lanes(self, local: dict) -> dict:
        """Arrays with a leading dim over this rank's lanes -> over all
        ``S_pad`` lanes, from every rank in block order."""
        if self.mesh is None:
            return local
        parts = gather_objects(self.mesh, local)
        return {k: np.concatenate([p[k] for p in parts]) for k in local}

    def _owned(self, lanes, fn) -> dict:
        """{s: fn(local index of s)} for every lane of ``lanes``, each
        computed by the rank that runs it and gathered."""
        mine = {s: fn(s - self.block.start) for s in lanes if s in self.block}
        out = {}
        for part in gather_objects(self.mesh, mine):
            out.update(part)
        return out

    def gather_trajectories(self) -> dict:
        """The real lanes' params, stacked (S, ...) on the CPU, from every
        rank (a collective under a lane mesh)."""
        local = {k: v.detach().cpu() for k, v in self.state["params"].items()}
        parts = gather_objects(self.mesh, local)
        return {k: torch.cat([p[k] for p in parts])[:self.S] for k in local}

    # -- scaffold hooks ------------------------------------------------------
    def _stage_data(self):
        """Data plane: one dataset per distinct (seed, partition, alpha),
        staged once and shared; the scalar plane and the per-lane root keys
        and fault models (the host cohort draws)."""
        cfg = getattr(self.job.model, "cfg", None)
        if self.ragged:
            self._stage_ragged(cfg)
            return
        cache, trajs, keys = {}, [], []
        for fl_s in self._fls_pad:
            k = (fl_s.seed, fl_s.partition, fl_s.dirichlet_alpha)
            if k not in cache:
                cache[k] = make_dataset(self.job.raw, fl_s, cfg).distribute_into_chunks(
                    fl_s.partition, fl_s.n_clients, fl_s.dirichlet_alpha)
            trajs.append(cache[k])
            keys.append(k)
        self.data = trajs                # per-lane host views (eval_fn), all S_pad
        self.staged, self.lane_ds = stage_partitions_dedup(trajs, keys, self.device,
                                                           mesh=self.mesh)
        self.roots = shard_lanes(sweeps.root_keys(self._fls_pad, self.device), self.mesh)
        self.hyper = shard_lanes(sweeps.scalar_plane(self._fls_pad, self.device), self.mesh)
        self.faults = [make_fault(self.job.raw, fl_s) for fl_s in self._fls_local]

    def _stage_ragged(self, cfg):
        """Ragged lanes: one slab stager per distinct plan key (the host
        cohort draw depends on the population and cohort sizes and on the
        fault seed, not only on the dataset), stacked by
        ``StackedSlabStager``; no root is staged up front."""
        cache, lanes = {}, []
        for fl_s in self.fls:
            k = (fl_s.seed, fl_s.partition, fl_s.dirichlet_alpha, fl_s.n_clients,
                 fl_s.cohort, fl_s.max_cohort, fl_s.straggler_overprovision,
                 fl_s.streaming)
            if k not in cache:
                cache[k] = make_slab_stager(make_dataset(self.job.raw, fl_s, cfg), fl_s,
                                            make_fault(self.job.raw, fl_s), self.device)
            lanes.append(cache[k])
        self.stager = StackedSlabStager(lanes)
        self.data = [getattr(ln, "data", None) for ln in lanes]
        self.staged, self.lane_ds = None, None
        self.roots = sweeps.root_keys(self.fls, self.device)
        self.hyper = sweeps.scalar_plane(self.fls, self.device)
        self.faults = [make_fault(self.job.raw, fl_s) for fl_s in self.fls]

    def _init_state(self):
        """Each lane's initial state is its single run's, stacked (this
        rank's lanes)."""
        fl = self.job.fl
        self.decentralized = (self.mode == "sync" and self.placement == "spatial"
                              and fl.topology == "decentralized")
        self.state = stack_lanes([
            init_state(self.job.model, self.job.strategy, fl,
                       determinism.root_key(fl_s.seed), n_clients_local=fl.n_clients,
                       device=self.device, decentralized=self.decentralized)
            for fl_s in self._fls_local])

    def _build_schedule(self, n_rounds: int):
        """Per-lane virtual-clock schedules, deduplicated on (seed,
        partition, alpha, staleness_exponent); ``lane_sched`` maps each
        lane to its unique schedule."""
        from repro_torch.core.async_rounds import async_init_state
        from repro_torch.runtime.clock import build_schedule

        fl = self.job.fl
        lens = np.asarray([[len(p) for p in parts] for _, _, parts in self.data],
                          np.float32)                                # (S_pad, C)
        cache, uniq, lane_u = {}, [], []
        for s, fl_s in enumerate(self._fls_pad):
            k = (fl_s.seed, fl_s.partition, fl_s.dirichlet_alpha,
                 fl_s.staleness_exponent)
            if k not in cache:
                cache[k] = len(uniq)
                uniq.append(build_schedule(
                    make_fault(self.job.raw, fl_s), fl.n_clients,
                    n_rounds * self.events_per_round, lens[s],
                    buffer_size=fl.async_buffer,
                    staleness_exponent=fl_s.staleness_exponent,
                    max_staleness=fl.max_staleness,
                    concurrency=fl.async_concurrency))
            lane_u.append(cache[k])
        self.uniq_schedules = uniq
        self.schedules = [uniq[u] for u in lane_u]   # per-lane host views
        self.schedule = self.schedules[0]            # horizon checks read len()
        self.lane_sched = lane_u
        occ = [buffer_occupancy(sc.accept, sc.apply) for sc in uniq]
        self._occupancy_lane = np.stack([occ[u] for u in lane_u])
        if "hist" not in self.state:
            ring = uniq[0].ring
            self.state = stack_lanes([
                async_init_state(lane_of(self.state, i), ring, fl, self.job.strategy)
                for i in range(len(self.block))])

    def _maybe_restore(self):
        """Resume from the newest checkpoint of the same grid (its lane
        count and coordinates digest ride in the manifest), elastically: the
        file holds the S real lanes, and this rank takes its block of them,
        its pad lanes (frozen at their initial state from launch 1) from the
        fresh scaffold. A checkpoint saved at one ``lane_devices`` resumes
        at any other."""
        if not self.ckpt_dir:
            return
        last = ckpt_mod.latest_round(self.ckpt_dir)
        if last is None:
            return
        host, extra = ckpt_mod.read(self.ckpt_dir, last)
        if extra.get("campaign_lanes") != self.S or \
                extra.get("campaign_grid") != self._coords_digest():
            raise ValueError(
                f"checkpoint was written by another sweep grid "
                f"({extra.get('campaign_lanes')} lanes, digest "
                f"{extra.get('campaign_grid')}) than this one ({self.S} lanes, "
                f"digest {self._coords_digest()}); a resume needs the same grid "
                "(lane_devices may differ); point ckpt_dir elsewhere to start "
                "the new grid fresh")
        like = ckpt_mod.leaves(self.state)
        if len(like) != len(host):
            raise ValueError(f"checkpoint has {len(host)} leaves, the state needs {len(like)}")
        lo, real = self.block.start, max(min(self.block.stop, self.S) - self.block.start, 0)

        def fit(h, t):
            saved = ckpt_mod.as_leaf(h, t)
            if saved.shape[1:] != t.shape[1:] or saved.shape[0] != self.S \
                    or saved.dtype != t.dtype:
                raise ValueError(f"checkpoint leaf {tuple(saved.shape)} {saved.dtype} does "
                                 f"not fit the campaign's {tuple(t.shape)} {t.dtype} "
                                 f"(S = {self.S})")
            return torch.cat([saved[lo:lo + real].to(t.device), t[real:]])

        self.state = ckpt_mod.rebuild(self.state, iter([fit(h, t) for h, t in zip(host, like)]))
        self.round_idx = extra["next_round"]

    def _save_checkpoint(self):
        """The single-device checkpoint of the real lanes: the ranks' blocks
        gathered, rank 0 writes."""
        if self.mesh is None:
            super()._save_checkpoint()
            return
        parts = gather_objects(self.mesh, [t.detach().cpu() for t in
                                           ckpt_mod.leaves(self.state)])
        if self._writer:
            whole = [torch.cat(ts)[:self.S] for ts in zip(*parts)]
            ckpt_mod.save(self.ckpt_dir, self.round_idx,
                          ckpt_mod.rebuild(self.state, iter(whole)),
                          extra=self._ckpt_extra())
        barrier(self.mesh)

    def _coords_digest(self) -> str:
        """Digest of the expanded sweep coordinates: the grid's identity."""
        canon = repr([sorted(c.items()) for c in self.coords])
        return hashlib.sha256(canon.encode()).hexdigest()[:16]

    def _ckpt_extra(self) -> dict:
        return dict(super()._ckpt_extra(), campaign_lanes=self.S,
                    campaign_grid=self._coords_digest())

    def _post_restore(self):
        """Resume: re-adopt the rows of the rounds before the resume, so the
        table the resumed run writes is whole."""
        if self.round_idx > 0 and self.out_dir:
            prior = pathlib.Path(self.out_dir) / "campaign.csv"
            if prior.exists():
                self.results = [r for r in read_results(prior)
                                if r["round"] < self.round_idx]
        if self._table is not None:
            self._table.reset()

    def _record_plane_bytes(self):
        if not self.recorder.enabled:
            return
        data = self.stager.device_bytes if self.ragged else tree_nbytes(self.staged)
        self.recorder.counter("staged_bytes", track=self.telemetry_track,
                              data_plane=int(data), scalar_plane=tree_nbytes(self.hyper))

    # -- launches ------------------------------------------------------------
    def _skip_dead_bucket(self, n: int):
        """Every lane dropped: nothing to run."""
        self._tail_rows = []
        return [{"n_alive": 0, "round_s": 0.0} for _ in range(n)]

    def _launch_sync(self, start: int, n: int):
        if not self.alive_lanes():
            return self._skip_dead_bucket(n)
        t0 = time.perf_counter()
        staged = self._slab(start, n) if self.ragged else self.staged
        self.state, metrics = self._multi(self.state, staged, self.roots, start,
                                          n, self._launch_hyper(), self.faults)
        self._sync()
        dt = self._round_seconds(time.perf_counter() - t0)
        stacked = self._gather_lanes({k: v.cpu().numpy() for k, v in metrics.items()})
        self._capture_probes(start, n, stacked.pop("probes", None))
        cols = self._account_comms(start, n)
        self._merge_comms_stacked(stacked, cols)        # (S_pad, n) each
        return self._table_rows(stacked, start, n, dt)

    def _round_seconds(self, dt: float) -> float:
        """A launch's seconds: every rank's (``rank_round_s``), the
        slowest's in the table."""
        per = gather_objects(self.mesh, dt)
        self.rank_round_s.append(per)
        return max(per)

    def _launch_async(self, start: int, n: int):
        if not self.alive_lanes():
            return self._skip_dead_bucket(n)
        epr = self.events_per_round
        n_ev = n * epr
        t0 = time.perf_counter()
        self.state, metrics = self._multi(
            self.state, self.staged, self.uniq_schedules,
            self.lane_sched[self.block.start:self.block.stop], self.roots,
            start * epr, n_ev, self._launch_hyper())
        self._sync()
        dt = self._round_seconds(time.perf_counter() - t0)
        local = {k: np.asarray(v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
                 .reshape(len(self.block), n, epr) for k, v in metrics.items() if k != "probes"}
        probes = self._reduce_async_probes(metrics.pop("probes", None), n)
        if probes is not None:
            local["probes"] = probes
        ev = self._gather_lanes(local)
        probes = ev.pop("probes", None)
        if probes is not None:
            self._capture_probes(
                start, n, probes, extra=self._async_probe_extras(start, n),
                hists={f"probe:staleness_hist:lane{s}": staleness_hist(
                    ev["staleness"][s], self.job.fl.max_staleness)
                    for s in self.alive_lanes()})
        cols = self._account_comms(start, n)
        idx = (start + np.arange(1, n + 1)) * epr - 1
        stacked = {"loss": ev["loss"].mean(-1),
                   "staleness": ev["staleness"].mean(-1),
                   "applied": ev["applied"].sum(-1),
                   "vtime": np.stack([np.asarray(sc.vtime, np.float64)[idx]
                                      for sc in self.schedules])}
        self._merge_comms_stacked(stacked, cols)
        rows = self._table_rows(stacked, start, n, dt)
        for r in rows:
            r["events_per_s"] = n_ev / max(dt, 1e-9)
        return rows

    def _async_probe_extras(self, start: int, n: int):
        epr = self.events_per_round
        occ = self._occupancy_lane[:, start * epr:(start + n) * epr]
        return {"buffer_occ": occ.reshape(self.S_pad, n, epr).mean(-1)}

    def _table_rows(self, stacked, start: int, n: int, dt: float):
        """Per-(lane, round) rows into the results table (alive lanes
        only); per-round rows of alive-lane means for the logger."""
        self._tail_rows = []
        live = self.alive_lanes()
        for s in live:
            for i in range(n):
                row = {**self.coords[s], "traj": s, "round": start + i,
                       **{k: float(v[s, i]) for k, v in stacked.items()},
                       "round_s": dt / n}
                self.results.append(row)
                if i == n - 1:
                    self._tail_rows.append((s, row))
        idx = np.asarray(live, np.int64)
        return [dict({k: float(v[idx, i].mean()) for k, v in stacked.items()},
                     round_s=dt / n, n_alive=len(live)) for i in range(n)]

    # -- boundary hooks, per lane --------------------------------------------
    def _lane_digests(self, lanes) -> dict:
        return self._owned(lanes, lambda i: param_digest(lane_of(self.state["params"], i)))

    def _ledger_record(self, last: int):
        """One ``global`` block per alive lane: lane s's digest is its
        single run's, so the chain certifies params a run produced."""
        digs = self._lane_digests(self.alive_lanes())
        for s in self.alive_lanes():
            self.job.ledger.append(last, "global", {"digest": digs[s]})
            self.kv.publish(f"global_digest/{last}/traj{s}", digs[s])

    def _merge_eval(self, rows):
        """Per-lane eval into each alive lane's tail row; means into the
        logger's row."""
        agg = {}
        evs = self._owned([s for s, _ in self._tail_rows], lambda i: {
            k: float(v) for k, v in self.eval_fn(lane_of(self.state["params"], i)).items()})
        for s, row in self._tail_rows:
            ev = evs[s]
            row.update(ev)
            for k, v in ev.items():
                agg.setdefault(k, []).append(v)
        rows[-1].update({k: float(np.mean(v)) for k, v in agg.items()})

    def _digest_record(self, marks, last: int):
        """The async digest cadence per alive lane, each block at its lane's
        virtual time."""
        digs = self._lane_digests(self.alive_lanes())
        for s in self.alive_lanes():
            dig = digs[s]
            for m in marks:
                self._digest_blocks += 1
                self.job.ledger.append(
                    last, "async_digest",
                    {"event": int(m), "traj": s,
                     "vtime": float(self.schedules[s].vtime[m - 1]), "digest": dig})

    # -- probes, per lane -----------------------------------------------------
    def _capture_probes(self, start, n, probes, extra=None, hists=None):
        """(S, n, P) probes -> rows keyed like campaign.csv, alive lanes
        only (dead lanes emit zeros in the round and no rows here)."""
        if probes is None:
            return
        a = np.asarray(probes)
        cols = {name: a[..., j].tolist() for j, name in enumerate(PROBE_NAMES)}
        if extra:
            cols.update({k: np.asarray(v).tolist() for k, v in extra.items()})
        items = sorted(cols.items())
        alive = self.alive_lanes()
        self._probe_lanes = [(s, f"lane{s}") for s in alive]
        for s in alive:
            coords = dict(self.coords[s], traj=s)
            for i in range(n):
                row = dict(coords, round=start + i)
                row.update((k, col[s][i]) for k, col in items)
                self.probe_rows.append(row)
        self._pending_probes = (start, n, cols, hists or {})

    def _probe_series(self, m, i: int) -> dict:
        return {label: m[s][i] for s, label in self._probe_lanes}

    def _probe_lead_columns(self):
        return [*self.spec.names, "traj", "round"]

    # -- comms, per lane -------------------------------------------------------
    def _comms_setup(self):
        """One ``LaneComms`` per lane, from the lane's config and fault
        model; the shape template drops the lane dim (and a decentralized
        state's client dim)."""
        if not self.comms_spec.enabled:
            return
        from repro_torch.core.netmodel import shape_template
        tpl = shape_template(self.state["params"], strip_leading=True)
        if self.decentralized:
            tpl = shape_template(tpl, strip_leading=True)
        self._comms = [comms_mod.LaneComms(
            fl=fl_s, csm=make_fault(self.job.raw, fl_s), template=tpl,
            pods=self.comms_spec.pods) for fl_s in self.fls]

    def _account_comms(self, start: int, n: int):
        """Alive lanes account their rounds, dropped lanes hold their
        cumulative columns; rows keyed like campaign.csv, alive lanes."""
        if self._comms is None:
            return None
        per = []
        for s, lane in enumerate(self._comms):
            if self.alive[s] > 0:
                per.append(lane.async_rounds(start, n, self.schedules[s],
                                             self.events_per_round)
                           if self.mode == "async" else lane.sync_rounds(start, n))
            else:
                per.append(lane.frozen(n))
        cols = {k: np.stack([p[k] for p in per]) for k in per[0]}
        items = sorted(cols.items())
        alive = self.alive_lanes()
        self._comms_lanes = [(s, f"lane{s}") for s in alive]
        for s in alive:
            coords = dict(self.coords[s], traj=s)
            for i in range(n):
                row = dict(coords, round=start + i)
                row.update((k, float(col[s][i])) for k, col in items)
                self.comms_rows.append(row)
        self._pending_comms = (start, n, cols)
        return cols

    def _merge_comms_stacked(self, stacked: dict, cols):
        if cols:
            stacked.update({k: cols[k] for k in comms_mod.RESULT_COLUMNS})

    def _comms_series(self, m, i: int) -> dict:
        return {label: float(m[s][i]) for s, label in self._comms_lanes}

    def _comms_summaries(self) -> list:
        if self._comms is None:
            return []
        return [dict(lane.summary(), lane=s) for s, lane in enumerate(self._comms)]

    def _comms_lead_columns(self):
        return [*self.spec.names, "traj", "round"]

    # -- flight-recorder hooks ---------------------------------------------
    def _telemetry_attrs(self) -> dict:
        return {"n_alive": len(self.alive_lanes()), "S": self.S, "S_pad": self.S_pad}

    def _record_lane_telemetry(self):
        """``lane_occupancy`` when it changed (first launch, each drop),
        with each rank's alive lanes under a lane mesh (a block of
        ``S_pad // lane_devices``: the one with dead lanes idles its card
        for them)."""
        values = {"alive": len(self.alive_lanes()), "total": self.S}
        if self.lane_devices:
            per = self.S_pad // self.lane_devices
            for d in range(self.lane_devices):
                values[f"shard{d}_alive"] = int((self.alive[d * per:(d + 1) * per] > 0).sum())
        if values != getattr(self, "_last_occupancy", None):
            self._last_occupancy = values
            self.recorder.counter("lane_occupancy", track=self.telemetry_track,
                                  **values)

    # -- results table ---------------------------------------------------------
    def _lead_columns(self):
        return [*self.spec.names, "traj", "round"]

    def _finish_chunk(self, start: int, n: int, rows):
        super()._finish_chunk(start, n, rows)
        if self._table is not None:
            with self.recorder.span("table_flush", track=self.telemetry_track):
                self._table.flush(self.results, self._lead_columns())

    def _out_path(self, knob, stem: str):
        return super()._out_path(knob, stem) if self._writer else None

    def run(self, rounds: Optional[int] = None):
        state, logger = super().run(rounds)
        if self._table is not None:
            self._table.flush(self.results, self._lead_columns())
            if self.parquet:
                write_parquet(self.results, self._lead_columns(), self.out_dir)
        return state, logger

    def trajectory_params(self, s: int):
        """Lane ``s``'s params (bitwise its single run's; frozen at the drop
        round for a dropped lane); under a lane mesh, on the rank that runs
        it (``gather_trajectories`` collects every lane)."""
        if s not in self.block:
            raise ValueError(f"lane {s} runs on another rank (this one runs "
                             f"{self.block.start}..{self.block.stop - 1}); use "
                             "gather_trajectories()")
        return lane_of(self.state["params"], s - self.block.start)

    def write_results(self, out_dir=None):
        """Write the whole results table: ``campaign.csv`` (and
        ``campaign.parquet`` where it can)."""
        out = pathlib.Path(out_dir or self.out_dir or ".")
        out.mkdir(parents=True, exist_ok=True)
        path = AppendTable(out / "campaign.csv").flush(self.results, self._lead_columns())
        write_parquet(self.results, self._lead_columns(), out)
        return path
