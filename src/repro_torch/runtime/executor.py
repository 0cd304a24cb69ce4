"""Host-level FL executor (port of the sync, resident subset of
``repro/runtime/executor.py``).

``scaffold()`` stages the whole client partition on the device once and
initializes the state; ``run()`` is the chunk loop: ``rounds_per_launch``
rounds run back to back on the device (``core/rounds.build_multi_round``),
then one synchronisation per chunk, then the chunk-boundary host work —
per-round log rows with ``loss`` and ``round_s``, and ``eval_fn`` merged into
the chunk's last row. By the round loop's determinism contract every chunking
gives bitwise the same params for the same seed.

Checkpointing, telemetry, probes, comms and the ledger are not yet ported
(ROADMAP A8, A11, A14): the executor takes no checkpoint directory, and
``core/jobs.load_job`` refuses the telemetry/probes/comms sections and a
ledger.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

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
    eval_fn: Optional[Callable] = None    # (params) -> dict of metrics
    logger: Optional[PerformanceLogger] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.logger = self.logger or PerformanceLogger(run_name=self.job.name)
        validate_cohort(self.job.fl)
        self._multi = build_multi_round(
            self.job.model, self.job.strategy, self.job.fl,
            fault=self.job.fault, device=self.device)

    def scaffold(self):
        """Stage the dataset on the device, then initialize the state."""
        fl = self.job.fl
        x, y, parts = self.job.dataset.distribute_into_chunks(
            fl.partition, fl.n_clients, fl.dirichlet_alpha)
        self.data = (x, y, parts)   # host view, kept for eval_fn consumers
        self.staged = stage_partitions(x, y, parts, self.device)
        self.root = determinism.root_key(fl.seed)
        self.state = init_state(self.job.model, self.job.strategy, fl,
                                self.root, n_clients_local=fl.n_clients,
                                device=self.device)
        self.round_idx = 0
        return self

    def run(self, rounds: Optional[int] = None):
        """Run (or continue) the chunked round loop up to ``rounds``."""
        rounds = rounds or self.job.fl.rounds
        chunk = max(self.job.fl.rounds_per_launch, 1)
        while self.round_idx < rounds:
            start = self.round_idx
            n = min(chunk, rounds - start)
            t0 = time.perf_counter()
            self.state, metrics = self._multi(self.state, self.staged,
                                              self.root, start, n)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            losses = metrics["loss"].tolist()
            rows = [{"loss": losses[i], "round_s": dt / n} for i in range(n)]
            if self.eval_fn is not None:
                rows[-1].update({k: float(v) for k, v in
                                 self.eval_fn(self.state["params"]).items()})
            for i in range(n):
                self.logger.log_round(start + i, **rows[i])
            self.round_idx += n
        return self.state, self.logger
