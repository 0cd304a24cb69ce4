"""Heterogeneous campaign execution + lane scheduling (successive halving);
port of ``repro/runtime/scheduler.py``, host Python.

``PlanExecutor`` is the runtime half of the campaign planner
(``core/plan.py``): it instantiates one ``CampaignExecutor`` per program-
signature bucket and drives all buckets in **lockstep** over round chunks —
so a heterogeneous strategy x topology x seed grid runs as B lane-vmapped
campaigns (B = #signatures), not S sequential processes, and a
campaign-wide scheduler can compare lanes *across* buckets at every chunk
boundary.

The lane scheduler implements successive halving / early stopping on top of
the per-round tidy table: at each rung it ranks the alive lanes by the
latest value of a metric and drops the worst ``1 - 1/eta`` fraction. The
per-lane ``alive`` mask is a runtime input to the rounds
(``rounds.freeze_unless``), so a dropped lane's
state simply freezes at its drop round, its rows stop landing in the table,
and the drop decision is recorded in the ledger (kind ``lane_drop``) for
auditable campaign provenance.

Contracts (tests/test_torch_plan.py):
- scheduler off: every lane bitwise-equals its independent single run (the
  bucket executors inherit the campaign's contract; the planner only groups);
- scheduler on: a surviving lane is STILL bitwise its full single run
  (vmap lanes are independent — the mask only gates state writes), and a
  dropped lane's params equal its single run truncated at the drop round;
- the merged ``campaign.csv`` is keyed by (bucket, lane, sweep coords) and
  appends per chunk;
- resume re-adopts drop decisions from the decision journal
  (``decisions.jsonl``, one entry per visited boundary) and re-decides at
  most the one tail boundary a crash can leave unrecorded — from the
  re-adopted table, whose rows regenerate bitwise, so the replay is
  deterministic.
"""
from __future__ import annotations

import dataclasses
import math
import pathlib
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.jobs import rebind
from repro_torch.core.plan import build_plan
from repro_torch.runtime.campaign import (AppendTable, CampaignExecutor,
                                    write_parquet)
from repro_torch.telemetry.recorder import FlightRecorder


@dataclasses.dataclass(frozen=True)
class SuccessiveHalving:
    """Rung policy: at every ``rung_every`` rounds keep the best
    ``ceil(alive / eta)`` lanes (never fewer than ``min_lanes``) by
    ``metric`` (``mode`` = "min" for losses, "max" for accuracies).

    ``decide`` is a pure function of (round, per-lane metric values), which
    is what makes resume-replay deterministic."""
    metric: str = "loss"
    mode: str = "min"                 # min | max
    rung_every: int = 1               # rounds between rungs
    eta: float = 2.0                  # keep 1/eta per rung
    min_lanes: int = 1

    def __post_init__(self):
        if self.mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', got {self.mode!r}")
        if self.eta <= 1.0:
            raise ValueError(f"eta must be > 1, got {self.eta}")
        if self.rung_every < 1:
            raise ValueError(f"rung_every must be >= 1, got {self.rung_every}")

    def is_rung(self, round_idx: int, prev_round: Optional[int] = None):
        """Did a rung fire between ``prev_round`` (exclusive) and
        ``round_idx`` (inclusive)? Chunk boundaries are the only rounds a
        campaign can act on, so a rung is "crossed" — not "landed on
        exactly": rung_every=5 with rounds_per_launch=4 still halves at
        boundaries 8, 12, 16, ... (one rung each), instead of silently
        skipping every rung that isn't a multiple of the chunk size."""
        if prev_round is None:
            prev_round = round_idx - 1
        return round_idx > 0 and \
            round_idx // self.rung_every > prev_round // self.rung_every

    def decide(self, round_idx: int, metrics: Dict[Any, float],
               prev_round: Optional[int] = None) -> List[Any]:
        """Lanes to drop at this boundary (empty off-rung). ``metrics``
        maps lane keys -> the metric's latest value; ties break by lane key
        (grid order), so decisions are deterministic. ``prev_round`` is the
        previous boundary (rung-crossing detection); omitted, only exact
        rung multiples fire."""
        if not self.is_rung(round_idx, prev_round) \
                or len(metrics) <= self.min_lanes:
            return []
        sign = 1.0 if self.mode == "min" else -1.0
        ranked = sorted(metrics, key=lambda k: (sign * metrics[k], k))
        keep = max(self.min_lanes, math.ceil(len(ranked) / self.eta))
        return ranked[keep:]


@dataclasses.dataclass
class PlanExecutor:
    """Bucketed heterogeneous campaign: one ``CampaignExecutor`` per
    program signature, advanced in lockstep, with optional lane scheduling.

    ``job`` must carry a ``sweep:`` section (categorical axes welcome).
    ``out_dir`` (if set) receives the merged table ``campaign.csv`` keyed
    by (bucket, lane, sweep coords), the ``decisions.jsonl`` journal
    (scheduler on) and one sub-table per bucket; ``ckpt_dir`` shards into
    per-bucket checkpoint dirs, and a scheduled checkpointed campaign
    requires ``out_dir`` (resume re-adopts the drop decisions from it).
    """
    job: Any
    scheduler: Optional[SuccessiveHalving] = None
    out_dir: Optional[str] = None
    ckpt_dir: Optional[str] = None
    eval_fn: Optional[Callable] = None
    # Shard each bucket's sweep axis over this many ranks (0 = no
    # sharding; a MeshConfig's `lanes` axis is also accepted). Buckets
    # shard *independently*: each pads its own lane count up to a multiple
    # of the rank count with dead lanes. Every rank holds the whole tidy
    # table (the buckets gather their rows), so every rank's scheduler
    # decides the same drops; rank 0 alone writes the files.
    lane_devices: int = 0
    device: Any = None                # None -> cuda; "cpu" on the CPU

    def scaffold(self):
        if self.job.sweep is None:
            raise ValueError("PlanExecutor needs a job with a sweep: "
                             "section (see core/sweeps.py for the axes)")
        if self.scheduler is not None and self.ckpt_dir and not self.out_dir:
            raise ValueError(
                "a scheduled campaign with ckpt_dir needs out_dir: drop "
                "decisions replay from the results table + decision "
                "journal on resume, and without them previously dropped "
                "lanes would silently resurrect")
        self.plan = build_plan(self.job.fl, self.job.sweep, self.job.arch)
        # ONE shared flight recorder for the whole plan: each bucket's
        # executor records onto its own track ("bucket<i>"), the lockstep
        # loop onto "plan" — so the exported trace shows per-bucket launch
        # lanes side by side under a single clock.
        self.recorder = FlightRecorder.from_job(self.job,
                                                fallback_dir=self.out_dir)
        self.execs: List[CampaignExecutor] = []
        for bucket in self.plan.buckets:
            sub = f"bucket{bucket.index}"
            ex = CampaignExecutor(
                rebind(self.job, bucket.fls[0]),
                lanes=(bucket.coords, bucket.fls),
                out_dir=(str(pathlib.Path(self.out_dir) / sub)
                         if self.out_dir else None),
                ckpt_dir=(str(pathlib.Path(self.ckpt_dir) / sub)
                          if self.ckpt_dir else None),
                eval_fn=self.eval_fn, parquet=False,
                lane_scheduling=self.scheduler is not None,
                lane_devices=self.lane_devices, device=self.device,
                recorder=self.recorder, telemetry_track=sub)
            ex.scaffold()
            self.execs.append(ex)
        self._writer = self.execs[0]._writer
        self._mesh = self.execs[0].mesh
        # a crash can leave buckets at different rounds; the lockstep loop
        # lets the laggards catch up (run(rounds=r) no-ops past r)
        self.round_idx = min(ex.round_idx for ex in self.execs)
        self.dropped: Dict[int, int] = {}      # global lane -> drop round
        self._merged: list = []                # incremental merged rows
        self._taken = [0] * len(self.execs)    # per-bucket rows consumed
        self._table = (AppendTable(pathlib.Path(self.out_dir) /
                                   "campaign.csv")
                       if self.out_dir and self._writer else None)
        self._journal = (pathlib.Path(self.out_dir) / "decisions.jsonl"
                         if self.out_dir and self.scheduler is not None
                         else None)
        if self.scheduler is not None and self.round_idx > 0:
            self._replay_decisions()
        elif self._journal is not None and self._journal.exists() and self._writer:
            self._journal.unlink()             # fresh campaign, stale file
        return self

    # -- lockstep chunk loop ----------------------------------------------
    def run(self, rounds: Optional[int] = None):
        fl = self.job.fl
        rounds = rounds or fl.rounds
        # the scheduler needs control at every chunk boundary; without one
        # each bucket can run its whole horizon in one call (the bucket's
        # own chunk loop still does the per-chunk boundary I/O)
        chunk = (max(fl.rounds_per_launch, 1)
                 if self.scheduler is not None else rounds)
        rec = self.recorder
        while self.round_idx < rounds:
            prev = self.round_idx
            n = min(chunk, rounds - prev)
            target = prev + n
            for ex in self.execs:
                ex.run(rounds=target)
            self.round_idx = target
            if self.scheduler is not None:
                with rec.span("scheduler", track="plan", round=target):
                    dropped = self._apply_decisions(target, prev,
                                                    record=True)
                    self._journal_append(target, prev, dropped)
            if self._table is not None:
                with rec.span("table_flush", track="plan"):
                    self._table.flush(self.rows(), self._lead_columns())
        if self.out_dir and self._writer:
            with rec.span("parquet", track="plan"):
                self._write_parquet()
            if any(ex.probe_rows for ex in self.execs):
                with rec.span("probe_flush", track="plan"):
                    self.write_probes()
            if any(ex.comms_rows for ex in self.execs):
                with rec.span("comms_flush", track="plan"):
                    self.write_comms()
        rec.flush()
        return self

    # -- lane scheduling ---------------------------------------------------
    def _lane_metrics(self, round_idx: int):
        """Per-lane metric (alive lanes only) from the tidy tables: the
        rows of round ``round_idx - 1``, the chunk tail every bucket just
        flushed. Scans each table backwards and stops once every alive
        lane reported, so the live path reads O(S * chunk) rows. Also
        returns the column names seen on those rows (typo diagnostics)."""
        name = self.scheduler.metric
        out: Dict[int, float] = {}
        seen: set = set()
        for bucket, ex in zip(self.plan.buckets, self.execs):
            want = set(ex.alive_lanes())
            for row in reversed(ex.results):
                if not want:
                    break
                if row["round"] == round_idx - 1 and row["traj"] in want:
                    want.discard(row["traj"])
                    seen.update(row)
                    if name in row:
                        out[bucket.lane_ids[row["traj"]]] = float(row[name])
        return out, seen

    def _apply_decisions(self, round_idx: int, prev_round: int,
                         record: bool) -> List[int]:
        metrics, seen_cols = self._lane_metrics(round_idx)
        if not metrics and seen_cols and \
                self.scheduler.is_rung(round_idx, prev_round):
            import difflib
            hint = difflib.get_close_matches(self.scheduler.metric,
                                             sorted(seen_cols), n=1)
            suffix = (f" — did you mean {hint[0]!r}?" if hint
                      else f"; table columns: {sorted(seen_cols)}")
            raise KeyError(
                f"lane scheduler metric {self.scheduler.metric!r} appears "
                f"in no round-{round_idx - 1} row{suffix}")
        lanes = self.scheduler.decide(round_idx, metrics, prev_round)
        for lane in lanes:
            self._drop(lane, round_idx, record,
                       metric=metrics.get(lane))
        return lanes

    def _drop(self, lane: int, round_idx: int, record: bool, metric=None):
        b, j = self.plan.lane_bucket(lane)
        self.execs[b].drop_lane(j)
        self.dropped[lane] = round_idx
        if record and self.job.ledger is not None:
            payload = {"lane": lane, "bucket": b,
                       "coord": dict(self.plan.coords[lane])}
            if metric is not None:
                payload[self.scheduler.metric] = metric
            self.job.ledger.append(round_idx, "lane_drop", payload)

    def _journal_append(self, round_idx: int, prev_round: int, dropped):
        """Record the boundary in the decision journal — the exact
        boundary sequence the live loop visited (it depends on the run()
        horizons, so a resume cannot reconstruct it from the chunk size
        alone) plus which lanes were dropped there."""
        if self._journal is None or not self._writer:
            return
        import json
        with open(self._journal, "a") as f:
            f.write(json.dumps({"round": round_idx, "prev": prev_round,
                                "dropped": list(dropped)}) + "\n")

    def _replay_decisions(self):
        """Resume path: re-adopt the decision journal — the recorded
        boundaries (≤ the resumed round) re-apply their drops verbatim
        (and re-record them into this process's fresh ledger); entries
        past the resumed round are discarded (the resumed run will re-make
        them identically — decisions are a pure function of the table,
        which regenerates bitwise). Only the crash window between a
        checkpoint save and its boundary's journal append can leave the
        tail boundary unrecorded; that boundary re-decides from the
        re-adopted table, which is exactly what the live run would have
        done there."""
        import json
        from repro_torch.launch.mesh import barrier

        resumed = self.round_idx
        kept, last = [], 0
        if self._journal is not None and self._journal.exists():
            for line in self._journal.read_text().splitlines():
                e = json.loads(line)
                if e["round"] <= resumed:
                    kept.append(e)
                    for lane in e["dropped"]:
                        self._drop(lane, e["round"], record=True)
                    last = max(last, e["round"])
            barrier(self._mesh)            # every rank read before rank 0 writes
            # truncate: boundaries past the resume point get re-made live
            if self._writer:
                with open(self._journal, "w") as f:
                    for e in kept:
                        f.write(json.dumps(e) + "\n")
        if last < resumed:
            dropped = self._apply_decisions(resumed, last, record=True)
            self._journal_append(resumed, last, dropped)

    # -- merged results ----------------------------------------------------
    def _lead_columns(self):
        return ["bucket", "lane", *self.plan.spec.names, "traj", "round"]

    def rows(self) -> list:
        """The merged tidy table: every bucket's rows keyed by (bucket,
        global lane, sweep coords), in (round, lane) order. Maintained
        incrementally — each call merges only rows that appeared since the
        last one, so per-boundary cost is O(S * chunk), not O(S * R)."""
        new = []
        for b, (bucket, ex) in enumerate(zip(self.plan.buckets,
                                             self.execs)):
            for row in ex.results[self._taken[b]:]:
                new.append({"bucket": bucket.index,
                            "lane": bucket.lane_ids[row["traj"]], **row})
            self._taken[b] = len(ex.results)
        # new rows all belong to rounds past the already-merged prefix, so
        # sorting just the batch keeps the whole list in (round, lane) order
        new.sort(key=lambda r: (r["round"], r["lane"]))
        self._merged.extend(new)
        return self._merged

    def write_results(self, out_dir=None):
        out = pathlib.Path(out_dir or self.out_dir or ".")
        table = AppendTable(out / "campaign.csv")
        path = table.flush(self.rows(), self._lead_columns())
        self._write_parquet(out)
        return path

    def probe_rows(self) -> list:
        """The merged probe table: every bucket's probe rows keyed like the
        merged results — (bucket, global lane, sweep coords, traj, round)
        — in (round, lane) order. The per-bucket ``probes_bucket<i>.csv``
        files stay the incrementally-flushed artifacts."""
        out = []
        for bucket, ex in zip(self.plan.buckets, self.execs):
            for row in ex.probe_rows:
                out.append({"bucket": bucket.index,
                            "lane": bucket.lane_ids[row["traj"]], **row})
        out.sort(key=lambda r: (r["round"], r["lane"]))
        return out

    def write_probes(self, out_dir=None):
        """Write the merged ``probes.csv`` (the lockstep loop calls this at
        the end of a probed run; also an explicit export entry point)."""
        from repro_torch.core.probes import ProbeTable
        rows = self.probe_rows()
        if not rows:
            return None
        out = pathlib.Path(out_dir or self.out_dir or ".")
        out.mkdir(parents=True, exist_ok=True)
        table = ProbeTable(out / "probes.csv",
                           ["bucket", "lane", *self.plan.spec.names,
                            "traj", "round"])
        return table.flush(rows)

    def comms_rows(self) -> list:
        """The merged comms table: every bucket's comms rows keyed like the
        merged results — (bucket, global lane, sweep coords, traj, round)
        — in (round, lane) order. The per-bucket ``comms_bucket<i>.csv``
        files stay the incrementally-flushed artifacts."""
        out = []
        for bucket, ex in zip(self.plan.buckets, self.execs):
            for row in ex.comms_rows:
                out.append({"bucket": bucket.index,
                            "lane": bucket.lane_ids[row["traj"]], **row})
        out.sort(key=lambda r: (r["round"], r["lane"]))
        return out

    def write_comms(self, out_dir=None):
        """Write the merged ``comms.csv`` (the lockstep loop calls this at
        the end of a comms-accounted run; also an explicit export entry
        point)."""
        from repro_torch.core.probes import ProbeTable
        rows = self.comms_rows()
        if not rows:
            return None
        out = pathlib.Path(out_dir or self.out_dir or ".")
        out.mkdir(parents=True, exist_ok=True)
        table = ProbeTable(out / "comms.csv",
                           ["bucket", "lane", *self.plan.spec.names,
                            "traj", "round"])
        return table.flush(rows)

    def _write_parquet(self, out_dir=None):
        write_parquet(self.rows(), self._lead_columns(),
                      out_dir or self.out_dir or ".")

    # -- introspection -----------------------------------------------------
    def lane_params(self, lane: int):
        """Global lane ``lane``'s params (bitwise its single run's, frozen
        at the drop round if the scheduler dropped it)."""
        b, j = self.plan.lane_bucket(lane)
        return self.execs[b].trajectory_params(j)

    def compiled_programs(self) -> int:
        """Distinct launch keys across buckets: the number of program
        signatures (per launch length), not the number of trajectories."""
        return sum(ex.compiled_programs() for ex in self.execs)

    @property
    def S(self) -> int:
        return self.plan.size
