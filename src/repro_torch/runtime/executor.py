"""Host-level FL executor (port of the single-run subset of
``repro/runtime/executor.py``) — paper Algorithm 1.

``scaffold()`` stages the whole client partition on the device once (or,
on the ragged client plane, builds a slab stager), initializes the state,
builds the async event schedule where the job is async, resumes from the
newest checkpoint in ``ckpt_dir`` if there is one, and builds the comms
accountant; ``run()`` is the chunk loop:
``rounds_per_launch`` rounds run back to back on the device, then one
synchronisation per chunk, then the chunk-boundary host work: the ledger's
``global`` block (``job.ledger``, one per chunk, its digest published in the
control-plane store as ``global_digest/<last round>``), ``eval_fn`` merged
into the chunk's last row, per-round log rows, ``probes.csv`` and
``comms.csv`` rows, the async ``digest_every_events`` blocks, and a
checkpoint whenever the chunk crossed a multiple of ``checkpoint_every``.
By the round loops' determinism contract every chunking, and a run resumed
from a checkpoint, gives bitwise the same params for the same seed.

The round programs take the job's sweepable scalars as device tensors
(``self.hyper``: f32, the seed int64), as a campaign lane takes its own, so
that lane s of a campaign computes what the single run of its config does.

Alg. 1's Logic Controller state lives in ``self.kv`` (``core/kvstore.py``):
ProcessPhase 0=init 1=local-learning 2=aggregation; NodeStage 0=not-ready
1=ready-for-job 2=ready-with-dataset 3=busy 4=waiting/complete, one key per
client node.

Observability, all host-side (trajectories are bitwise the same with it on
or off): the flight recorder (a ``telemetry:`` section,
``telemetry/recorder.py``) spans the scaffold hooks, every chunk, launch
and boundary step, and records per-launch counters: ``staged_bytes``,
``host``, ``program_cost`` (FlopCounterMode's flops of each launch key's
first launch), ``layers`` (the launch's layer spans, ``telemetry/recorder.
layer_span``), the ``probe:*`` and ``comms:*`` tracks, and at the end
``quant_agg`` (B1 calls), ``programs`` (distinct launch keys) and
``comms_total``. The round probes (a ``probes:`` section,
``core/probes.py``) land in ``probes.csv``; the comms plane (a ``comms:``
section, ``telemetry/comms.py``) in ``comms.csv`` and the result rows.

``fl.placement`` selects the sync round: "spatial" (every client at once;
"auto" resolves to it) or "temporal" (one client at a time). ``fl.mode``
"async" runs FedAsync/FedBuff over the virtual clock
(``core/async_rounds.py``): a "round" is ``events_per_round`` server events
(one FedBuff flush, or for FedAsync one arrival per client on average).

The ragged client plane (``fl.max_cohort > 0``, ``self.ragged``): no
population is staged; ``self.stager`` (``data/pipeline.make_slab_stager``)
hands each launch the slab of its rounds (sync) or of its event window
(async), addressed by absolute round or event, so chunking and a resume
change nothing. The next chunk's slab is kicked off before the current
chunk's launches start: the host launches kernels until the chunk ends, so
a later kick would overlap nothing. ``round_s`` keeps its window, from
taking the slab to the chunk's ``torch.cuda.synchronize()``, which also
waits for a next chunk's copy still in flight on the side stream. The
``staged_bytes`` counter gains ``slab``, ``peak_slab`` and
``resident_equiv`` per launch.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.configs.base import SWEEPABLE_SCALARS
from repro_torch.core import determinism
from repro_torch.core.blockchain import param_digest
from repro_torch.core.jobs import validate_cohort
from repro_torch.core.kvstore import KVStore
from repro_torch.core.plan import resolve_placement
from repro_torch.core.probes import (ASYNC_REDUCE, PROBE_NAMES, ProbeSpec,
                                     ProbeTable, buffer_occupancy,
                                     staleness_hist)
from repro_torch.core.rounds import build_multi_round, build_ragged_multi, init_state
from repro_torch.data.pipeline import (SyntheticLM, make_slab_stager, slab_nbytes,
                                      stage_partitions)
from repro_torch.kernels import build as kernel_build
from repro_torch.kernels import ops as kernel_ops
from repro_torch.metrics.logger import PerformanceLogger, host_usage
from repro_torch.runtime.device import resolve_device
from repro_torch.telemetry import comms as comms_mod
from repro_torch.telemetry.recorder import FlightRecorder


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride, padding,
                        dilation, transposed, output_padding, groups, output_mask,
                        out_shape, **kw) -> int:
    """torch's flop formula for a convolution's backward, with the weight
    gradient of a grouped convolution divided by its groups (torch counts
    it as if ungrouped; the clients' vmapped convs are grouped)."""
    from torch.utils import flop_counter
    args = (grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
            transposed, output_padding, groups)
    grad_in = flop_counter.conv_backward_flop(*args, [output_mask[0], False, False],
                                              out_val=out_shape)
    grad_w = flop_counter.conv_backward_flop(*args, [False, output_mask[1], False],
                                             out_val=out_shape)
    return grad_in + grad_w // groups


def tree_nbytes(tree) -> int:
    """Bytes of a tree's tensors (shapes and dtypes only)."""
    return int(sum(t.numel() * t.element_size() for t in ckpt_mod.leaves(tree)))


@dataclasses.dataclass
class Executor:
    """Scaffold a job on the device and run its chunked round loop."""
    job: Any                              # core.jobs.Job
    device: Any = None                    # None -> cuda (raises without a card)
    ckpt_dir: Optional[str] = None
    eval_fn: Optional[Callable] = None    # (params) -> dict of metrics
    logger: Optional[PerformanceLogger] = None
    # None -> built from the job's ``telemetry:`` section (a no-op recorder
    # without one); the planner passes one shared recorder, one track per
    # bucket
    recorder: Optional[FlightRecorder] = None
    telemetry_track: str = "run"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.kv = KVStore()
        self.logger = self.logger or PerformanceLogger(run_name=self.job.name)
        if self.recorder is None:
            self.recorder = FlightRecorder.from_job(
                self.job, fallback_dir=getattr(self, "out_dir", None))
        self._launches = 0                # launch ordinal (profile_chunks)
        self.probes_spec = ProbeSpec.from_job(self.job)
        self.probe_rows = []              # tidy per-round probe rows
        self._probe_flushed = 0
        self._probe_table = None
        self._pending_probes = None       # launch stash for the drain
        self.comms_spec = comms_mod.CommsSpec.from_job(self.job)
        self.comms_rows = []              # tidy per-round comms rows
        self._comms = None                # the LaneComms accountant (scaffold)
        self._comms_flushed = 0
        self._comms_table = None
        self._pending_comms = None
        self._digest_blocks = 0
        t = (getattr(self.job, "raw", None) or {}).get("telemetry") or {}
        self._cost_enabled = bool(t.get("cost_analysis", True))
        self._cost_seen = set()
        self._keys_seen = set()           # launch keys (mode, n): "programs"
        fl = self.job.fl
        validate_cohort(fl)
        self.placement = resolve_placement(fl)
        self.mode = fl.mode
        # the ragged client plane: launches read per-chunk cohort slabs from
        # a slab stager instead of a resident root
        self.ragged = fl.max_cohort > 0
        self.stager = None
        spec = self.probes_spec
        if self.mode == "async":
            self.events_per_round = (fl.async_buffer if fl.async_buffer > 1
                                     else fl.n_clients)
            self._multi = self._build_async(spec)
        elif self.mode == "sync":
            self._multi = self._build_sync(spec)
        else:
            raise ValueError(f"unknown mode {self.mode!r} (want 'sync' or 'async')")
        # the sweepable scalars as runtime values, as a campaign lane's
        self.hyper = {"seed": torch.tensor(fl.seed, dtype=torch.int64,
                                           device=self.device)}
        self.hyper.update({k: torch.tensor(float(getattr(fl, k)), dtype=torch.float32,
                                           device=self.device)
                           for k in SWEEPABLE_SCALARS if k != "seed"})

    def _build_sync(self, spec):
        if self.ragged:
            return build_ragged_multi(
                self.job.model, self.job.strategy, self.job.fl,
                placement=self.placement, probes=spec.enabled,
                on_divergence=spec.on_divergence)
        return build_multi_round(
            self.job.model, self.job.strategy, self.job.fl,
            placement=self.placement, fault=self.job.fault, device=self.device,
            probes=spec.enabled, on_divergence=spec.on_divergence)

    def _build_async(self, spec):
        from repro_torch.core.async_rounds import build_async_multi
        return build_async_multi(self.job.model, self.job.strategy, self.job.fl,
                                 probes=spec.enabled,
                                 on_divergence=spec.on_divergence,
                                 ragged=self.ragged)

    def compiled_programs(self) -> int:
        """Distinct launch keys ``(mode, n)`` this executor has run: the
        port's count of round programs (it compiles none)."""
        return len(self._keys_seen)

    # -- Alg. 1 lines 1-15: scaffold --------------------------------------
    def scaffold(self):
        """Stage the dataset on the device, initialize the state, build the
        async schedule, resume from the newest checkpoint if any, then
        build the comms accountant; each hook under a recorder span. An LM
        job (``synthetic_lm``, or an LM arch on any dataset) raises
        ``ValueError`` before anything is drawn: LMs train through
        ``repro_torch.launch.train_fl_lm``, as in the JAX package, whose
        executor cannot stage that dataset either."""
        if isinstance(self.job.dataset, SyntheticLM) or self.job.model.cfg.family != "small":
            raise ValueError(
                "the executor stages partitioned datasets; an LM job "
                f"({self.job.arch}, {type(self.job.dataset).__name__}) trains through "
                "python -m repro_torch.launch.train_fl_lm")
        fl = self.job.fl
        rec, track = self.recorder, self.telemetry_track
        with rec.span("scaffold", track=track):
            self.kv.set_process_phase(0)
            self.nodes = [f"client_{i}" for i in range(fl.n_clients)]
            for n in self.nodes:             # "DownloadJobConfig <- True"
                self.kv.set_node_stage(n, 1)
            with rec.span("stage_data", track=track):
                self._stage_data()
            for n in self.nodes:
                self.kv.set_node_stage(n, 2)
            with rec.span("init_state", track=track):
                self._init_state()
            if self.mode == "async":
                with rec.span("build_schedule", track=track):
                    self._build_schedule(fl.rounds)
            self.round_idx = 0
            with rec.span("restore", track=track):
                self._maybe_restore()
            self._post_restore()
            self._comms_setup()
            self._record_plane_bytes()
        return self

    def _stage_data(self):
        """"DownloadDataset": the one-time device staging of the partition,
        or on the ragged plane the slab stager (staging per chunk)."""
        fl = self.job.fl
        if self.ragged:
            self.stager = make_slab_stager(self.job.dataset, fl, self.job.fault,
                                           self.device)
            self.staged = None
            self.data = getattr(self.stager, "data", None)
            return
        x, y, parts = self.job.dataset.distribute_into_chunks(
            fl.partition, fl.n_clients, fl.dirichlet_alpha)
        self.data = (x, y, parts)   # host view, kept for eval_fn consumers
        self.staged = stage_partitions(x, y, parts, self.device)

    def _init_state(self):
        fl = self.job.fl
        self.root = determinism.root_key(fl.seed)
        # one model per client only where the round gossips them: the
        # temporal and async drivers ignore the topology
        self.decentralized = (self.mode == "sync" and self.placement == "spatial"
                              and fl.topology == "decentralized")
        self.state = init_state(self.job.model, self.job.strategy, fl,
                                self.root, n_clients_local=fl.n_clients,
                                device=self.device, decentralized=self.decentralized)

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

    def _record_plane_bytes(self):
        """Counter: device bytes staged per plane (data, async schedules,
        scalars), from shapes and dtypes."""
        if not self.recorder.enabled:
            return
        # ragged: the resident stager's root (0 streaming); each launch's
        # slab lands as its own counter
        data = self.stager.device_bytes if self.ragged else tree_nbytes(self.staged)
        values = {"data_plane": int(data), "scalar_plane": tree_nbytes(self.hyper)}
        if getattr(self, "sched_dev", None) is not None:
            values["schedule_plane"] = tree_nbytes(self.sched_dev)
        self.recorder.counter("staged_bytes", track=self.telemetry_track, **values)

    def _record_slab_bytes(self, slab):
        """Counter per ragged launch: the slab it staged, the stager's
        running peak, and what full residency would have cost."""
        if self.recorder.enabled:
            self.recorder.counter("staged_bytes", track=self.telemetry_track,
                                  slab=slab_nbytes(slab),
                                  peak_slab=int(self.stager.peak_slab_bytes),
                                  resident_equiv=int(self.stager.resident_bytes))

    def _build_schedule(self, n_rounds: int):
        """Precompute the virtual-clock event schedule (async) on the host
        and put its per-event arrays on the device."""
        from repro_torch.core.async_rounds import async_init_state
        from repro_torch.runtime.clock import ClientSystemModel, build_schedule

        fl = self.job.fl
        csm = self.job.fault
        if not isinstance(csm, ClientSystemModel):
            csm = ClientSystemModel(**dataclasses.asdict(csm))
        lens = (np.asarray(self.stager.lens, np.float32) if self.ragged
                else np.asarray([len(p) for p in self.data[2]], np.float32))
        self.schedule = build_schedule(
            csm, fl.n_clients, n_rounds * self.events_per_round, lens,
            buffer_size=fl.async_buffer,
            staleness_exponent=fl.staleness_exponent,
            max_staleness=fl.max_staleness,
            concurrency=fl.async_concurrency)
        self.sched_dev = self.schedule.device_arrays(self.device)
        # the buffer-occupancy probe: a function of the schedule alone
        self._occupancy = buffer_occupancy(self.schedule.accept,
                                           self.schedule.apply)
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

    def _post_restore(self):
        """Hook after a restore (campaigns re-adopt their results table)."""

    # -- Alg. 1 lines 16-57: the chunk loop ---------------------------------
    def run(self, rounds: Optional[int] = None):
        """Run (or continue) the chunked round loop up to ``rounds``."""
        rounds = rounds or self.job.fl.rounds
        self._run_total = rounds      # how far the ragged stager prefetches
        launch = self._launch_sync
        if self.mode == "async":
            self._check_async_horizon(rounds)
            launch = self._launch_async
        rec = self.recorder
        if not rec.enabled:
            return self._chunk_loop(rounds, launch)
        with kernel_ops.quant_agg_scope() as qframe:
            out = self._chunk_loop(rounds, launch)
        rec.counter("quant_agg", track=self.telemetry_track,
                    calls=qframe["calls"],
                    batched_fallbacks=qframe["batched_fallbacks"])
        rec.counter("programs", track=self.telemetry_track,
                    compiled=self.compiled_programs())
        for values in self._comms_summaries():
            rec.counter("comms_total", track=self.telemetry_track, **values)
        rec.flush()
        return out

    def _chunk_loop(self, rounds: int, launch):
        chunk = max(self.job.fl.rounds_per_launch, 1)
        rec, track = self.recorder, self.telemetry_track
        while self.round_idx < rounds:
            start = self.round_idx
            n = min(chunk, rounds - start)
            # Alg. 1 phases 1 and 2 (local learning, aggregation) both run
            # inside the launch
            self.kv.set_process_phase(1)
            for node in self.nodes:
                self.kv.set_node_stage(node, 3)
            self.kv.set_process_phase(2)
            with rec.span("chunk", track=track, start=start, n=n):
                rows = self._recorded_launch(launch, start, n)
                with rec.span("finish_chunk", track=track):
                    self._finish_chunk(start, n, rows)
        if self._comms_table is not None:
            self._comms_table.close()
        return self.state, self.logger

    def _launch_key(self, n: int):
        return (self.mode, n * (self.events_per_round if self.mode == "async" else 1))

    def _recorded_launch(self, launch, start: int, n: int):
        """One launch under a ``launch`` span (closed after the launch's
        ``torch.cuda.synchronize()``) carrying ``compile_delta`` (kernel
        libraries built or loaded during it), ``quant_agg_traces`` (its B1
        calls) and the executor's own attrs, with the layer spans on and
        drained into its ``layers`` counter; then the ``host``, lane,
        ``program_cost``, probe and comms counters."""
        key = self._launch_key(n)
        rec = self.recorder
        if not rec.enabled:
            self._keys_seen.add(key)
            return launch(start, n)
        ordinal = self._launches
        self._launches += 1
        libs0 = kernel_build.loaded()
        calls0 = kernel_ops.quant_agg_stats()["calls"]
        first = key not in self._keys_seen
        self._keys_seen.add(key)
        counting = first and self._cost_enabled and key not in self._cost_seen
        with rec.profile(ordinal), \
                rec.span("launch", track=self.telemetry_track, mode=self.mode,
                         start=start, n=n, ordinal=ordinal) as sp, \
                rec.layers(self.telemetry_track):
            if counting:
                from torch.utils.flop_counter import FlopCounterMode
                with FlopCounterMode(display=False, custom_mapping={
                        torch.ops.aten.convolution_backward: _conv_backward_flop}) as fc:
                    rows = launch(start, n)
            else:
                rows = launch(start, n)
            sp.attrs.update(
                compile_delta=kernel_build.loaded() - libs0,
                quant_agg_traces=kernel_ops.quant_agg_stats()["calls"] - calls0,
                **self._telemetry_attrs())
        rec.counter("host", track=self.telemetry_track, **host_usage())
        self._record_lane_telemetry()
        if counting:
            self._cost_seen.add(key)
            # no bytes_accessed: nothing in torch counts a launch's bytes
            # (the JAX package's report reads the absent key as 0)
            rec.counter("program_cost", track=self.telemetry_track,
                        program=str(key), flops=float(fc.get_total_flops()))
        self._drain_probe_counters(sp._t0, rec._now_us())
        self._drain_comms_counters(sp._t0, rec._now_us())
        return rows

    def _telemetry_attrs(self) -> dict:
        """Executor-specific launch-span attrs (campaigns: lane occupancy)."""
        return {}

    def _record_lane_telemetry(self):
        """Post-launch counters hook (campaigns: lanes alive)."""

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _next_chunk(self, start: int, n: int) -> int:
        """Rounds in the chunk after [start, start + n) of this run."""
        chunk = max(self.job.fl.rounds_per_launch, 1)
        return min(chunk, self._run_total - (start + n))

    def _slab(self, start: int, n: int):
        """The ragged launch's slab; the next chunk's is kicked off before
        this one's launches start."""
        slab = self.stager.slab(start, n)
        self._record_slab_bytes(slab)
        self.stager.prefetch(start + n, self._next_chunk(start, n))
        return slab

    def _event_slab(self, e0: int, n_ev: int):
        """The ragged async launch's event slab, with the next window's
        kicked off before this one's events run."""
        clients = self.schedule.client
        slab = self.stager.event_slab(clients[e0:e0 + n_ev], tag=(e0, n_ev))
        self._record_slab_bytes(slab)
        epr = self.events_per_round
        nxt = self._next_chunk(e0 // epr, n_ev // epr) * epr
        if nxt > 0:
            e1 = e0 + n_ev
            self.stager.prefetch_events(clients[e1:e1 + nxt], tag=(e1, nxt))
        return slab

    def _launch_sync(self, start: int, n: int):
        t0 = time.perf_counter()
        staged = self._slab(start, n) if self.ragged else self.staged
        self.state, metrics = self._multi(self.state, staged, self.root,
                                          start, n, self.hyper)
        self._sync()
        dt = time.perf_counter() - t0
        self._capture_probes(start, n, metrics.pop("probes", None))
        return self._merge_comms([{"loss": v, "round_s": dt / n}
                                  for v in metrics["loss"].tolist()],
                                 self._account_comms(start, n))

    def _launch_async(self, start: int, n: int):
        """An async "round" is ``events_per_round`` server events."""
        epr = self.events_per_round
        n_ev = n * epr
        t0 = time.perf_counter()
        staged = self._event_slab(start * epr, n_ev) if self.ragged else self.staged
        self.state, metrics = self._multi(self.state, staged, self.schedule,
                                          self.sched_dev, self.root, start * epr,
                                          n_ev, self.hyper)
        self._sync()
        dt = time.perf_counter() - t0
        probes = self._reduce_async_probes(metrics.pop("probes", None), n)
        loss = metrics["loss"].cpu().numpy().reshape(n, epr)
        stale = metrics["staleness"].reshape(n, epr)
        applied = metrics["applied"].reshape(n, epr)
        if probes is not None:
            self._capture_probes(
                start, n, probes, extra=self._async_probe_extras(start, n),
                hists={"probe:staleness_hist": staleness_hist(
                    stale, self.job.fl.max_staleness)})
        vt = self.schedule.vtime
        return self._merge_comms(
            [{"loss": float(loss[i].mean()),
              "staleness": float(stale[i].mean()),
              "applied": float(applied[i].sum()),
              "vtime": float(vt[(start + i + 1) * epr - 1]),
              "round_s": dt / n,
              "events_per_s": n_ev / max(dt, 1e-9)} for i in range(n)],
            self._account_comms(start, n))

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

    # -- probes (core/probes.py) --------------------------------------------
    def _capture_probes(self, start: int, n: int, probes, extra=None, hists=None):
        """Stash a launch's (n, P) probe plane: tidy rows now (flushed to
        probes.csv at the boundary), counter samples at the drain."""
        if probes is None:
            return
        a = np.asarray(probes.cpu() if isinstance(probes, torch.Tensor) else probes)
        cols = {name: a[..., j].tolist() for j, name in enumerate(PROBE_NAMES)}
        if extra:
            cols.update({k: np.asarray(v).tolist() for k, v in extra.items()})
        items = sorted(cols.items())
        for i in range(n):
            row = {"round": start + i}
            row.update((k, col[i]) for k, col in items)
            self.probe_rows.append(row)
        self._pending_probes = (start, n, cols, hists or {})

    def _drain_probe_counters(self, t0_us: int, t1_us: int):
        """``probe:<name>`` counter tracks, per-round samples spread across
        the launch span they were computed in; histograms at its end."""
        pend, self._pending_probes = self._pending_probes, None
        if pend is None or not self.recorder.enabled:
            return
        start, n, mats, hists = pend
        rec, track = self.recorder, self.telemetry_track
        for i in range(n):
            t = int(t0_us + (t1_us - t0_us) * (i + 1) / n)
            for name, m in mats.items():
                rec.counter(f"probe:{name}", track=track, t_us=t,
                            **self._probe_series(m, i))
        for name, values in hists.items():
            rec.counter(name, track=track, t_us=t1_us, **values)

    def _probe_series(self, m, i: int) -> dict:
        """Counter series for round ``i`` (campaigns: one per alive lane)."""
        return {"value": m[i]}

    def _reduce_async_probes(self, probes, n: int):
        """(..., n_events, P) per-event probes -> (..., n, P) per round, by
        ``ASYNC_REDUCE`` over fixed event windows (chunking-invariant)."""
        if probes is None:
            return None
        epr = self.events_per_round
        a = probes.cpu().numpy()
        a = a.reshape(a.shape[:-2] + (n, epr, a.shape[-1]))
        out = np.empty(a.shape[:-3] + (n, a.shape[-1]), np.float32)
        for j, name in enumerate(PROBE_NAMES):
            out[..., j] = getattr(a[..., j], ASYNC_REDUCE.get(name, "mean"))(axis=-1)
        return out

    def _async_probe_extras(self, start: int, n: int):
        """Per-round mean buffer occupancy, from the schedule."""
        epr = self.events_per_round
        occ = self._occupancy[start * epr:(start + n) * epr]
        return {"buffer_occ": occ.reshape(n, epr).mean(-1)}

    def _probe_lead_columns(self):
        return ["round"]

    def _out_path(self, knob, stem: str) -> Optional[pathlib.Path]:
        """``<stem>.csv`` in the section's ``out_dir``, else the telemetry
        out_dir, else the executor's out_dir or ckpt_dir (rows stay in
        memory when none is set); planner buckets suffix their track."""
        out = knob or (self.recorder.out_dir if self.recorder.enabled else None) \
            or getattr(self, "out_dir", None) or self.ckpt_dir
        if out is None:
            return None
        name = (f"{stem}.csv" if self.telemetry_track == "run"
                else f"{stem}_{self.telemetry_track}.csv")
        return pathlib.Path(out) / name

    def _probe_path(self) -> Optional[pathlib.Path]:
        return self._out_path(self.probes_spec.out_dir, "probes")

    def _flush_probes(self):
        """Append the rows buffered since the last boundary to probes.csv;
        ``self.probe_rows`` keeps the full in-memory view either way."""
        new = self.probe_rows[self._probe_flushed:]
        self._probe_flushed = len(self.probe_rows)
        if self._probe_table is None:
            path = self._probe_path()
            if path is None:
                return
            self._probe_table = ProbeTable(path, self._probe_lead_columns())
        self._probe_table.flush(new)

    # -- comms (telemetry/comms.py) -----------------------------------------
    def _account_comms(self, start: int, n: int):
        """Advance the comms accountant over this launch's rounds and buffer
        their tidy rows (flushed to comms.csv at the chunk boundary).
        Returns the per-round column dict, or None with comms off."""
        if self._comms is None:
            return None
        lane = self._comms
        if self.mode == "async":
            cols = lane.async_rounds(start, n, self.schedule, self.events_per_round)
        else:
            cols = lane.sync_rounds(start, n)
        items = sorted(cols.items())
        for i in range(n):
            row = {"round": start + i}
            row.update((k, float(col[i])) for k, col in items)
            self.comms_rows.append(row)
        self._pending_comms = (start, n, cols)
        return cols

    def _merge_comms(self, rows, cols):
        """Join the simulated-time / cumulative-byte columns onto the
        launch's result rows (time-to-accuracy / bytes-to-accuracy axes)."""
        if cols:
            for i, row in enumerate(rows):
                row.update({k: float(cols[k][i]) for k in comms_mod.RESULT_COLUMNS})
        return rows

    def _drain_comms_counters(self, t0_us: int, t1_us: int):
        """``comms:*`` counter tracks: cumulative bytes per direction and
        the simulated clock, spread across the launch span."""
        pend, self._pending_comms = self._pending_comms, None
        if pend is None or not self.recorder.enabled:
            return
        start, n, cols = pend
        rec, track = self.recorder, self.telemetry_track
        for i in range(n):
            t = int(t0_us + (t1_us - t0_us) * (i + 1) / n)
            for name in comms_mod.COUNTER_COLUMNS:
                rec.counter(f"comms:{name}", track=track, t_us=t,
                            **self._comms_series(cols[name], i))

    def _comms_series(self, m, i: int) -> dict:
        return {"value": float(m[i])}

    def _comms_summaries(self) -> list:
        """Run-level comms totals (campaigns: one per lane)."""
        return [] if self._comms is None else [self._comms.summary()]

    def _comms_lead_columns(self):
        return ["round"]

    def _comms_path(self) -> Optional[pathlib.Path]:
        return self._out_path(self.comms_spec.out_dir, "comms")

    def _flush_comms(self):
        """Append the rows buffered since the last boundary to comms.csv;
        ``self.comms_rows`` keeps the full in-memory view either way."""
        new = self.comms_rows[self._comms_flushed:]
        self._comms_flushed = len(self.comms_rows)
        if self._comms_table is None:
            path = self._comms_path()
            if path is None:
                return
            self._comms_table = ProbeTable(path, self._comms_lead_columns())
        self._comms_table.flush(new)

    # -- the chunk boundary ---------------------------------------------------
    def _finish_chunk(self, start: int, n: int, rows):
        """Chunk-boundary host work: ledger record, eval (merged into the
        last round's row), logging, probes.csv, comms.csv, the async digest
        cadence, round-index advance, checkpoint when the chunk crossed a
        ``checkpoint_every`` multiple."""
        fl = self.job.fl
        rec, track = self.recorder, self.telemetry_track
        for node in self.nodes:
            self.kv.set_node_stage(node, 4)
        last = start + n - 1
        if self.job.ledger is not None:
            with rec.span("ledger", track=track):
                self._ledger_record(last)
        if self.eval_fn is not None:
            with rec.span("eval", track=track):
                self._merge_eval(rows)
        for i in range(n):
            self.logger.log_round(start + i, **rows[i])
        if len(self.probe_rows) > self._probe_flushed:
            with rec.span("probe_flush", track=track):
                self._flush_probes()
        if len(self.comms_rows) > self._comms_flushed:
            with rec.span("comms_flush", track=track):
                self._flush_comms()
        if self.mode == "async" and fl.digest_every_events > 0 and \
                self.job.ledger is not None:
            self._digest_cadence(start, n, last)
        self.round_idx += n
        if self.ckpt_dir and fl.checkpoint_every and \
                start // fl.checkpoint_every != self.round_idx // fl.checkpoint_every:
            with rec.span("checkpoint_save", track=track, round=self.round_idx):
                self._save_checkpoint()

    def _save_checkpoint(self):
        """Write the state as the round ``self.round_idx`` checkpoint."""
        ckpt_mod.save(self.ckpt_dir, self.round_idx, self.state, extra=self._ckpt_extra())

    def _ckpt_extra(self) -> dict:
        """Checkpoint manifest extras (campaigns add their grid)."""
        return {"next_round": self.round_idx}

    def _merge_eval(self, rows):
        """Eval at the chunk boundary (campaigns: per lane)."""
        rows[-1].update({k: float(v) for k, v in
                         self.eval_fn(self.state["params"]).items()})

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
        carrying the virtual arrival time of its mark: the block count,
        their marks and vtimes are the same for every chunking."""
        rec, track = self.recorder, self.telemetry_track
        epr = self.events_per_round
        d = self.job.fl.digest_every_events
        e0, e1 = start * epr, (start + n) * epr
        marks = range((e0 // d + 1) * d, e1 + 1, d)
        if not marks:
            return
        with rec.span("digest", track=track, events=e1, blocks=len(marks)):
            self._digest_record(marks, last)
        rec.counter("digest", track=track, blocks=self._digest_blocks)

    def _digest_record(self, marks, last: int):
        """The blocks of ``marks``, from one digest of the boundary state
        (campaigns: per alive lane)."""
        dig = param_digest(self.state["params"])
        for m in marks:
            self._digest_blocks += 1
            self.job.ledger.append(
                last, "async_digest",
                {"event": int(m), "vtime": float(self.schedule.vtime[m - 1]),
                 "digest": dig})
