"""Host-level FL executor (port of the resident, single-run subset of
``repro/runtime/executor.py``).

``scaffold()`` stages the whole client partition on the device once,
initializes the state, builds the async event schedule where the job is
async, and resumes from the newest checkpoint in ``ckpt_dir`` if there is
one; ``run()`` is the chunk loop: ``rounds_per_launch`` rounds run back to
back on the device, then one synchronisation per chunk, then the
chunk-boundary host work: per-round log rows, ``eval_fn`` merged into the
chunk's last row, and a checkpoint whenever the chunk crossed a multiple of
``checkpoint_every``. By the round loops' determinism contract every
chunking, and a run resumed from a checkpoint, gives bitwise the same params
for the same seed.

``fl.placement`` selects the sync round: "spatial" (every client at once;
"auto" resolves to it) or "temporal" (one client at a time). ``fl.mode``
"async" runs FedAsync/FedBuff over the virtual clock
(``core/async_rounds.py``): a "round" is ``events_per_round`` server events
(one FedBuff flush, or for FedAsync one arrival per client on average).

Telemetry, probes, comms and the ledger are not yet ported (ROADMAP A11,
A14); ``core/jobs.load_job`` refuses their sections and a ledger.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core import determinism
from repro_torch.core.jobs import validate_cohort
from repro_torch.core.rounds import build_multi_round, init_state
from repro_torch.data.pipeline import stage_partitions
from repro_torch.metrics.logger import PerformanceLogger
from repro_torch.runtime.device import resolve_device


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
        self.logger = self.logger or PerformanceLogger(run_name=self.job.name)
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
        """Stage the dataset on the device, initialize the state, build the
        async schedule, then resume from the newest checkpoint if any."""
        fl = self.job.fl
        x, y, parts = self.job.dataset.distribute_into_chunks(
            fl.partition, fl.n_clients, fl.dirichlet_alpha)
        self.data = (x, y, parts)   # host view, kept for eval_fn consumers
        self.staged = stage_partitions(x, y, parts, self.device)
        self.root = determinism.root_key(fl.seed)
        # one model per client only where the round gossips them: the
        # temporal and async drivers ignore the topology
        decentralized = (self.mode == "sync" and self.placement == "spatial"
                         and fl.topology == "decentralized")
        self.state = init_state(self.job.model, self.job.strategy, fl,
                                self.root, n_clients_local=fl.n_clients,
                                device=self.device, decentralized=decentralized)
        if self.mode == "async":
            self._build_schedule(fl.rounds)
        self.round_idx = 0
        self._maybe_restore()
        return self

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
            self._finish_chunk(start, n, launch(start, n))
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
        return [{"loss": v, "round_s": dt / n} for v in metrics["loss"].tolist()]

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
        return [{"loss": float(loss[i].mean()),
                 "staleness": float(stale[i].mean()),
                 "applied": float(applied[i].sum()),
                 "vtime": float(vt[(start + i + 1) * epr - 1]),
                 "round_s": dt / n,
                 "events_per_s": n_ev / max(dt, 1e-9)} for i in range(n)]

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
        """Chunk-boundary host work: eval (merged into the last round's
        row), logging, round-index advance, checkpoint when the chunk
        crossed a ``checkpoint_every`` multiple."""
        fl = self.job.fl
        if self.eval_fn is not None:
            rows[-1].update({k: float(v) for k, v in
                             self.eval_fn(self.state["params"]).items()})
        for i in range(n):
            self.logger.log_round(start + i, **rows[i])
        self.round_idx += n
        if self.ckpt_dir and fl.checkpoint_every and \
                start // fl.checkpoint_every != self.round_idx // fl.checkpoint_every:
            ckpt_mod.save(self.ckpt_dir, self.round_idx, self.state,
                          extra={"next_round": self.round_idx})
