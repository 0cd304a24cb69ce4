"""Host-level FL executor (port of the resident, single-run subset of
``repro/runtime/executor.py``) — paper Algorithm 1.

``scaffold()`` stages the whole client partition on the device once,
initializes the state, builds the async event schedule where the job is
async, resumes from the newest checkpoint in ``ckpt_dir`` if there is one,
and builds the comms accountant; ``run()`` is the chunk loop:
``rounds_per_launch`` rounds run back to back on the device, then one
synchronisation per chunk, then the chunk-boundary host work: the ledger's
``global`` block (``job.ledger``, one per chunk, its digest published in the
control-plane store as ``global_digest/<last round>``), ``eval_fn`` merged
into the chunk's last row, per-round log rows, ``comms.csv`` rows, the
async ``digest_every_events`` blocks, and a checkpoint whenever the chunk
crossed a multiple of ``checkpoint_every``. By the round loops' determinism
contract every chunking, and a run resumed from a checkpoint, gives bitwise
the same params for the same seed.

Alg. 1's Logic Controller state lives in ``self.kv`` (``core/kvstore.py``):
ProcessPhase 0=init 1=local-learning 2=aggregation; NodeStage 0=not-ready
1=ready-for-job 2=ready-with-dataset 3=busy 4=waiting/complete, one key per
client node.

The comms plane (``telemetry/comms.py``, a ``comms:`` job section) is pure
host bookkeeping: per-round byte totals and a simulated wall-clock, joined
onto the result rows (``sim_time_s``, ``cum_bytes``) and written to
``comms.csv`` in ``comms.out_dir`` (else ``ckpt_dir``; else the rows stay
in ``comms_rows``). Params are bitwise those of a run without it.

``fl.placement`` selects the sync round: "spatial" (every client at once;
"auto" resolves to it) or "temporal" (one client at a time). ``fl.mode``
"async" runs FedAsync/FedBuff over the virtual clock
(``core/async_rounds.py``): a "round" is ``events_per_round`` server events
(one FedBuff flush, or for FedAsync one arrival per client on average).

The flight recorder (spans, Perfetto counter tracks, and with it the comms
counter drain) and the round probes are not yet ported (ROADMAP A11);
``core/jobs.load_job`` refuses their sections.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core import determinism
from repro_torch.core.blockchain import param_digest
from repro_torch.core.jobs import validate_cohort
from repro_torch.core.kvstore import KVStore
from repro_torch.core.probes import ProbeTable
from repro_torch.core.rounds import build_multi_round, init_state
from repro_torch.data.pipeline import stage_partitions
from repro_torch.metrics.logger import PerformanceLogger
from repro_torch.runtime.device import resolve_device
from repro_torch.telemetry import comms as comms_mod


@dataclasses.dataclass
class Executor:
    """Scaffold a job on the device and run its chunked round loop."""
    job: Any                              # core.jobs.Job
    device: Any = None                    # None -> cuda (raises without a card)
    ckpt_dir: Optional[str] = None
    eval_fn: Optional[Callable] = None    # (params) -> dict of metrics
    logger: Optional[PerformanceLogger] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.kv = KVStore()
        self.logger = self.logger or PerformanceLogger(run_name=self.job.name)
        self.comms_spec = comms_mod.CommsSpec.from_job(self.job)
        self.comms_rows = []              # tidy per-round comms rows
        self._comms = None                # the LaneComms accountant (scaffold)
        self._comms_flushed = 0
        self._comms_table = None
        fl = self.job.fl
        validate_cohort(fl)
        self.placement = fl.placement if fl.placement != "auto" else "spatial"
        self.mode = fl.mode
        if self.mode == "async":
            from repro_torch.core.async_rounds import build_async_multi
            self.events_per_round = (fl.async_buffer if fl.async_buffer > 1
                                     else fl.n_clients)
            self._multi = build_async_multi(self.job.model, self.job.strategy, fl)
        elif self.mode == "sync":
            self._multi = build_multi_round(
                self.job.model, self.job.strategy, fl, placement=self.placement,
                fault=self.job.fault, device=self.device)
        else:
            raise ValueError(f"unknown mode {self.mode!r} (want 'sync' or 'async')")

    def scaffold(self):
        """Alg. 1 lines 1-15: stage the dataset on the device, initialize
        the state, build the async schedule, resume from the newest
        checkpoint if any, then build the comms accountant."""
        fl = self.job.fl
        self.kv.set_process_phase(0)
        self.nodes = [f"client_{i}" for i in range(fl.n_clients)]
        for n in self.nodes:             # "DownloadJobConfig <- True"
            self.kv.set_node_stage(n, 1)
        x, y, parts = self.job.dataset.distribute_into_chunks(
            fl.partition, fl.n_clients, fl.dirichlet_alpha)
        self.data = (x, y, parts)   # host view, kept for eval_fn consumers
        self.staged = stage_partitions(x, y, parts, self.device)
        for n in self.nodes:
            self.kv.set_node_stage(n, 2)
        self.root = determinism.root_key(fl.seed)
        # one model per client only where the round gossips them: the
        # temporal and async drivers ignore the topology
        self.decentralized = (self.mode == "sync" and self.placement == "spatial"
                              and fl.topology == "decentralized")
        self.state = init_state(self.job.model, self.job.strategy, fl,
                                self.root, n_clients_local=fl.n_clients,
                                device=self.device, decentralized=self.decentralized)
        if self.mode == "async":
            self._build_schedule(fl.rounds)
        self.round_idx = 0
        self._maybe_restore()
        self._comms_setup()
        return self

    def _comms_setup(self):
        """Build the comms accountant from the scaffolded params (shapes
        only); its counters start at zero, so a resumed run accounts only
        the rounds after the resume."""
        if not self.comms_spec.enabled:
            return
        from repro_torch.core.netmodel import shape_template
        # decentralized params carry a per-client leading dim; the byte
        # model prices ONE model's exchange
        tpl = shape_template(self.state["params"], strip_leading=self.decentralized)
        self._comms = comms_mod.LaneComms(fl=self.job.fl, csm=self.job.fault,
                                          template=tpl, pods=self.comms_spec.pods)

    def _build_schedule(self, n_rounds: int):
        """Precompute the virtual-clock event schedule (async) on the host
        and put its per-event arrays on the device."""
        from repro_torch.core.async_rounds import async_init_state
        from repro_torch.runtime.clock import ClientSystemModel, build_schedule

        fl = self.job.fl
        csm = self.job.fault
        if not isinstance(csm, ClientSystemModel):
            csm = ClientSystemModel(**dataclasses.asdict(csm))
        lens = np.asarray([len(p) for p in self.data[2]], np.float32)
        self.schedule = build_schedule(
            csm, fl.n_clients, n_rounds * self.events_per_round, lens,
            buffer_size=fl.async_buffer,
            staleness_exponent=fl.staleness_exponent,
            max_staleness=fl.max_staleness,
            concurrency=fl.async_concurrency)
        self.sched_dev = self.schedule.device_arrays(self.device)
        if "hist" not in self.state:
            self.state = async_init_state(self.state, self.schedule.ring, fl,
                                          self.job.strategy)

    def _maybe_restore(self):
        """Restart path: resume from the newest checkpoint in ``ckpt_dir``."""
        if self.ckpt_dir:
            last = ckpt_mod.latest_round(self.ckpt_dir)
            if last is not None:
                self.state, extra = ckpt_mod.restore(self.ckpt_dir, last, self.state)
                self.round_idx = extra["next_round"]

    def run(self, rounds: Optional[int] = None):
        """Run (or continue) the chunked round loop up to ``rounds``."""
        rounds = rounds or self.job.fl.rounds
        launch = self._launch_sync
        if self.mode == "async":
            self._check_async_horizon(rounds)
            launch = self._launch_async
        chunk = max(self.job.fl.rounds_per_launch, 1)
        while self.round_idx < rounds:
            start = self.round_idx
            n = min(chunk, rounds - start)
            # Alg. 1 phases 1 and 2 (local learning, aggregation) both run
            # inside the launch
            self.kv.set_process_phase(1)
            for node in self.nodes:
                self.kv.set_node_stage(node, 3)
            self.kv.set_process_phase(2)
            self._finish_chunk(start, n, launch(start, n))
        if self._comms_table is not None:
            self._comms_table.close()
        return self.state, self.logger

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _launch_sync(self, start: int, n: int):
        t0 = time.perf_counter()
        self.state, metrics = self._multi(self.state, self.staged, self.root,
                                          start, n)
        self._sync()
        dt = time.perf_counter() - t0
        return self._merge_comms([{"loss": v, "round_s": dt / n}
                                  for v in metrics["loss"].tolist()],
                                 self._account_comms(start, n))

    def _launch_async(self, start: int, n: int):
        """An async "round" is ``events_per_round`` server events."""
        epr = self.events_per_round
        n_ev = n * epr
        t0 = time.perf_counter()
        self.state, metrics = self._multi(self.state, self.staged, self.schedule,
                                          self.sched_dev, self.root, start * epr, n_ev)
        self._sync()
        dt = time.perf_counter() - t0
        loss = metrics["loss"].cpu().numpy().reshape(n, epr)
        stale = metrics["staleness"].reshape(n, epr)
        applied = metrics["applied"].reshape(n, epr)
        vt = self.schedule.vtime
        return self._merge_comms(
            [{"loss": float(loss[i].mean()),
              "staleness": float(stale[i].mean()),
              "applied": float(applied[i].sum()),
              "vtime": float(vt[(start + i + 1) * epr - 1]),
              "round_s": dt / n,
              "events_per_s": n_ev / max(dt, 1e-9)} for i in range(n)],
            self._account_comms(start, n))

    # -- comms (telemetry/comms.py) ----------------------------------------
    def _account_comms(self, start: int, n: int):
        """Advance the comms accountant over this launch's rounds and buffer
        their tidy rows (flushed to comms.csv at the chunk boundary).
        Returns the per-round column dict, or None with comms off."""
        if self._comms is None:
            return None
        if self.mode == "async":
            cols = self._comms.async_rounds(start, n, self.schedule,
                                            self.events_per_round)
        else:
            cols = self._comms.sync_rounds(start, n)
        items = sorted(cols.items())
        for i in range(n):
            row = {"round": start + i}
            row.update((k, float(col[i])) for k, col in items)
            self.comms_rows.append(row)
        return cols

    def _merge_comms(self, rows, cols):
        """Join the simulated-time / cumulative-byte columns onto the
        launch's result rows (time-to-accuracy / bytes-to-accuracy axes)."""
        if cols:
            for i, row in enumerate(rows):
                row.update({k: float(cols[k][i]) for k in comms_mod.RESULT_COLUMNS})
        return rows

    def _comms_summaries(self) -> list:
        """Run-level comms totals (one entry: this run's accountant)."""
        return [] if self._comms is None else [self._comms.summary()]

    def _comms_path(self) -> Optional[pathlib.Path]:
        """Where comms.csv lands: ``comms.out_dir``, else ``ckpt_dir``;
        None (rows in memory only) when neither is set."""
        out = self.comms_spec.out_dir or self.ckpt_dir
        return None if out is None else pathlib.Path(out) / "comms.csv"

    def _flush_comms(self):
        """Append the rows buffered since the last boundary to comms.csv;
        ``self.comms_rows`` keeps the full in-memory view either way."""
        new = self.comms_rows[self._comms_flushed:]
        self._comms_flushed = len(self.comms_rows)
        if self._comms_table is None:
            path = self._comms_path()
            if path is None:
                return
            self._comms_table = ProbeTable(path, ["round"])
        self._comms_table.flush(new)

    def _check_async_horizon(self, rounds: int):
        """The horizon grew past the scaffolded schedule? Regenerating is
        only safe before any event ran (or for FedAsync, which has no buffer
        groups): a FedBuff group left open at the old horizon would get
        other coefficients once the longer horizon closes it, which would
        de-normalize contributions already folded into the carries."""
        fl = self.job.fl
        if rounds * self.events_per_round > len(self.schedule):
            if self.round_idx > 0 and fl.async_buffer > 1:
                raise RuntimeError(
                    f"async run asked for {rounds} rounds mid-flight but the "
                    f"schedule covers {len(self.schedule) // self.events_per_round}; "
                    "scaffold with a larger fl.rounds (or resume from a "
                    "checkpoint) instead of growing a FedBuff run in place")
            self._build_schedule(rounds)

    def _finish_chunk(self, start: int, n: int, rows):
        """Chunk-boundary host work: ledger record, eval (merged into the
        last round's row), logging, comms.csv, the async digest cadence,
        round-index advance, checkpoint when the chunk crossed a
        ``checkpoint_every`` multiple."""
        fl = self.job.fl
        for node in self.nodes:
            self.kv.set_node_stage(node, 4)
        last = start + n - 1
        if self.job.ledger is not None:
            self._ledger_record(last)
        if self.eval_fn is not None:
            rows[-1].update({k: float(v) for k, v in
                             self.eval_fn(self.state["params"]).items()})
        for i in range(n):
            self.logger.log_round(start + i, **rows[i])
        if len(self.comms_rows) > self._comms_flushed:
            self._flush_comms()
        if self.mode == "async" and fl.digest_every_events > 0 and \
                self.job.ledger is not None:
            self._digest_cadence(start, n, last)
        self.round_idx += n
        if self.ckpt_dir and fl.checkpoint_every and \
                start // fl.checkpoint_every != self.round_idx // fl.checkpoint_every:
            ckpt_mod.save(self.ckpt_dir, self.round_idx, self.state,
                          extra={"next_round": self.round_idx})

    # -- the ledger (core/blockchain.py) -----------------------------------
    def _ledger_record(self, last: int):
        """One ``global`` block per chunk, for its last round; the digest is
        also published as ``global_digest/<last>``."""
        dig = param_digest(self.state["params"])
        # record_global's block, from the digest taken once
        self.job.ledger.append(last, "global", {"digest": dig})
        self.kv.publish(f"global_digest/{last}", dig)

    def _digest_cadence(self, start: int, n: int, last: int):
        """One ``async_digest`` block per ``digest_every_events`` mark the
        finished chunk crossed, each digesting the boundary state and
        carrying the virtual arrival time of its mark (ledger rows line up
        with the async virtual-time axis): the block count, their marks and
        vtimes are the same for every chunking."""
        epr = self.events_per_round
        d = self.job.fl.digest_every_events
        e0, e1 = start * epr, (start + n) * epr
        marks = range((e0 // d + 1) * d, e1 + 1, d)
        if not marks:
            return
        dig = param_digest(self.state["params"])
        for m in marks:
            self.job.ledger.append(
                last, "async_digest",
                {"event": int(m), "vtime": float(self.schedule.vtime[m - 1]),
                 "digest": dig})
