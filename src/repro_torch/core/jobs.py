"""Job configuration loader (port of ``repro/core/jobs.py``).

A job mirrors the paper's Fig. 2 sections. ``load_job`` validates every
section against the same known keys as the JAX package (a typo like
``cleint_lr`` fails with a near-miss hint) and resolves the model, strategy,
topology, dataset, ledger (``fl.blockchain``), fault model and sweep, and
checks the consensus name. A ``sweep:`` section expands the job into a
campaign (``core/sweeps.py``, ``runtime/campaign.py``); ``telemetry:`` and
``probes:`` turn on the flight recorder and the round probes;
``max_cohort > 0`` selects the ragged client plane (``streaming: true`` to
stream the sampled shards from the host, the ``synthetic_population``
dataset to generate them on demand). A setting whose code is not yet
ported fails here, at load time, naming the ROADMAP item; nothing unported
is silently ignored. What the ragged plane cannot run (per-client state,
the decentralized topology, temporal placement, async campaigns) fails here
too, with the JAX package's errors, which it raises when the executor is
built.
"""
from __future__ import annotations

import dataclasses
import difflib
import pathlib
from typing import Any, Optional

from repro_torch.configs.base import FLConfig, get_config
from repro_torch.core import sweeps
from repro_torch.core.blockchain import get_ledger
from repro_torch.core.consensus import CONSENSUS_REGISTRY
from repro_torch.core.plan import resolve_placement
from repro_torch.core.rounds import check_ragged_support
from repro_torch.core.strategies import get_strategy
from repro_torch.core.topology import get_topology
from repro_torch.data.pipeline import SyntheticLM, SyntheticPopulation, SyntheticVision
from repro_torch.models import model_zoo
from repro_torch.runtime.clock import ClientSystemModel
from repro_torch.runtime.faults import FaultModel


@dataclasses.dataclass
class Job:
    """A validated FL job: raw config dict plus resolved typed sections."""
    name: str
    fl: FLConfig
    arch: str
    model: Any
    strategy: Any
    topology: Any
    dataset: Any
    ledger: Any                # core.blockchain.HashChainLedger, or None
    fault: FaultModel
    raw: dict
    sweep: Optional[sweeps.SweepSpec] = None


_FL_KEYS = {f.name for f in dataclasses.fields(FLConfig)}
# the runtime section also takes the client-system and link knobs (the link
# knobs are read only by the comms plane, core/netmodel.py)
_CSM_KEYS = {f.name for f in dataclasses.fields(ClientSystemModel)}
_DATASET_KEYS = {"dataset", "n_items", "distribution", "items_per_client"}
_MODEL_KEYS = {"arch", "reduced"}
_STRATEGY_KEYS = {"strategy", "train_params", "aggregator_params"}
_TOP_KEYS = {"name", "model", "dataset", "consensus", "strategy", "runtime",
             "sweep", "clusters", "node_defaults", "node_configs",
             "telemetry", "probes", "comms"}
# flight-recorder knobs (telemetry/recorder.py): presence of the section
# turns the recorder on (enabled: false keeps a section but switches it off)
_TELEMETRY_KEYS = {"enabled", "out_dir", "profile_chunks", "cost_analysis"}
# round-probe knobs (core/probes.py)
_PROBES_KEYS = {"enabled", "out_dir", "on_divergence"}
# comms-observatory knobs (telemetry/comms.py): host-side wire-traffic
# accounting; the LinkModel knobs themselves are runtime: section fields
_COMMS_KEYS = {"enabled", "out_dir", "pods"}


def _check_keys(section_name: str, section, allowed) -> None:
    """Fail on unknown keys with a did-you-mean hint (no silent drops)."""
    if section is not None and not isinstance(section, dict):
        raise TypeError(f"job {section_name!r} section must be a mapping, "
                        f"got {type(section).__name__}: {section!r}")
    for k in section or {}:
        if k not in allowed:
            hint = difflib.get_close_matches(k, sorted(allowed), n=1)
            suffix = (f" — did you mean {hint[0]!r}?" if hint
                      else f"; known keys: {sorted(allowed)}")
            raise KeyError(
                f"unknown key {k!r} in job {section_name!r} section{suffix}")


def check_ported(raw: dict, fl: FLConfig) -> None:
    """Raise ``ValueError`` for a setting the port does not know."""
    if fl.mode not in ("sync", "async"):
        raise ValueError(f"unknown mode {fl.mode!r} (want 'sync' or 'async')")
    if fl.placement not in ("auto", "spatial", "temporal"):
        raise ValueError(f"unknown placement {fl.placement!r} "
                         "(want 'auto', 'spatial' or 'temporal')")
    if fl.consensus not in CONSENSUS_REGISTRY:
        hint = difflib.get_close_matches(fl.consensus, sorted(CONSENSUS_REGISTRY), n=1)
        suffix = (f" — did you mean {hint[0]!r}?" if hint
                  else f"; known: {sorted(CONSENSUS_REGISTRY)}")
        raise ValueError(f"unknown consensus {fl.consensus!r}{suffix}")
    if fl.compression not in ("none", "int8", "topk"):
        raise ValueError(f"unknown compression {fl.compression!r} "
                         "(want 'none', 'int8' or 'topk')")


def check_ragged(raw: dict, fl: FLConfig, strategy) -> None:
    """Raise ``ValueError`` for what the ragged client plane (``max_cohort
    > 0``) cannot run, as the JAX package does: a sync job it cannot honour
    (``rounds.check_ragged_support``), and a campaign of async lanes (the
    event schedule sizes by n_clients, a per-lane host value there)."""
    if fl.max_cohort <= 0:
        return
    if raw.get("sweep") and fl.mode == "async":
        raise ValueError(
            "ragged campaigns (max_cohort > 0) support sync mode only: the "
            "async event schedule sizes by n_clients, which the ragged plane "
            "makes a per-lane host value; run async ragged lanes as single "
            "Executors")
    if fl.mode == "sync":
        check_ragged_support(fl, strategy, resolve_placement(fl))


def check_client_state(fl: FLConfig, strategy) -> None:
    """Raise ``ValueError`` where the strategy's hooks index a per-client
    state that the driver does not carry: the temporal round and the async
    event loop pass none (the JAX package fails there with a TypeError).
    Strategies that only keep optional state (error feedback) run there
    without it, as in the JAX package."""
    where = ("mode 'async'" if fl.mode == "async"
             else "placement 'temporal'" if fl.placement == "temporal" else None)
    if where and strategy.reads_client_state:
        raise ValueError(
            f"strategy {fl.strategy!r} reads per-client state, which {where} "
            "does not carry; run it with mode 'sync' and placement 'spatial'")


def make_dataset(raw: dict, fl: FLConfig, cfg=None):
    """Dataset factory, seeded by ``fl.seed``."""
    ds = raw.get("dataset", {}) or {}
    kind = ds.get("dataset", "synthetic_vision")
    if kind == "synthetic_vision":
        kw = {}
        if cfg is not None and cfg.family == "small":
            # flsim-logreg is MNIST-shaped; cnn/mlp keep the CIFAR default
            from repro_torch.models.small import input_shape
            kw["shape"] = input_shape(cfg)
        return SyntheticVision(n_items=ds.get("n_items", 1024), seed=fl.seed,
                               **kw)
    if kind == "synthetic_population":
        # shards generated on demand for the streaming client plane, sized
        # by fl.n_clients and never materialized (needs streaming: true)
        kw = {}
        if cfg is not None and cfg.family == "small":
            from repro_torch.models.small import input_shape
            kw["shape"] = input_shape(cfg)
        return SyntheticPopulation(n_clients=fl.n_clients,
                                   items_per_client=ds.get("items_per_client", 8),
                                   seed=fl.seed, **kw)
    if kind == "synthetic_lm":
        vocab = (cfg.padded_vocab if cfg is not None
                 and cfg.family != "small" else 512)
        return SyntheticLM(vocab=vocab, seed=fl.seed)
    raise KeyError(f"unknown dataset {kind!r}")


def validate_cohort(fl: FLConfig) -> None:
    """Reject cohort settings that would silently misbehave."""
    if fl.cohort < 0 or fl.max_cohort < 0:
        raise ValueError(f"cohort={fl.cohort} / max_cohort={fl.max_cohort} "
                         "must be >= 0")
    if fl.cohort > fl.n_clients:
        raise ValueError(
            f"cohort={fl.cohort} exceeds n_clients={fl.n_clients}; an "
            "oversized cohort would silently clamp to the population — "
            "lower cohort or raise n_clients")
    target = fl.cohort or fl.n_clients
    if fl.max_cohort and fl.max_cohort < target:
        raise ValueError(
            f"max_cohort={fl.max_cohort} is smaller than the per-round "
            f"cohort ({target}); every sampled client needs a slab slot — "
            "raise max_cohort or lower cohort (cohort=0 samples all "
            "n_clients)")
    if fl.streaming and not fl.max_cohort:
        raise ValueError(
            "streaming: true requires ragged cohorts (max_cohort > 0) — "
            "resident staging has no per-chunk working set to stream")


def make_fault(raw: dict, fl: FLConfig) -> ClientSystemModel:
    """ClientSystemModel is a FaultModel: the sync path reads only the fault
    fields, the async virtual clock also reads the system ones. Seeded by
    ``fl.seed``."""
    rt = raw.get("runtime", {}) or {}
    defaults = ClientSystemModel()
    return ClientSystemModel(seed=fl.seed, **{
        f.name: rt.get(f.name, getattr(defaults, f.name))
        for f in dataclasses.fields(ClientSystemModel)
        if f.name not in ("seed", "worker_fail_prob")})


def rebind(job: Job, fl: FLConfig) -> Job:
    """A copy of ``job`` re-resolved around another FLConfig (a planner
    bucket's): strategy, topology, dataset and fault model are rebuilt; the
    model and the ledger (one chain per campaign) are shared."""
    check_client_state(fl, get_strategy(fl))
    return dataclasses.replace(
        job, fl=fl, strategy=get_strategy(fl),
        topology=get_topology(fl.topology, fl.gossip_steps),
        dataset=make_dataset(job.raw, fl, getattr(job.model, "cfg", None)),
        fault=make_fault(job.raw, fl))


def load_job(path_or_dict) -> Job:
    """Load and validate a job from a YAML path or config dict."""
    if isinstance(path_or_dict, (str, pathlib.Path)):
        import yaml
        raw = yaml.safe_load(pathlib.Path(path_or_dict).read_text())
    else:
        raw = dict(path_or_dict)

    strat = raw.get("strategy", {}) or {}
    ds = raw.get("dataset", {}) or {}
    cons = raw.get("consensus", {}) or {}
    rt = raw.get("runtime", {}) or {}
    _check_keys("top-level", raw, _TOP_KEYS)
    _check_keys("strategy", strat, _STRATEGY_KEYS)
    _check_keys("strategy.train_params", strat.get("train_params"), _FL_KEYS)
    _check_keys("strategy.aggregator_params", strat.get("aggregator_params"),
                _FL_KEYS)
    _check_keys("consensus", cons, _FL_KEYS)
    _check_keys("dataset", ds, _DATASET_KEYS)
    _check_keys("dataset.distribution", ds.get("distribution"), _FL_KEYS)
    _check_keys("model", raw.get("model"), _MODEL_KEYS)
    _check_keys("runtime", rt, _FL_KEYS | _CSM_KEYS)
    _check_keys("telemetry", raw.get("telemetry"), _TELEMETRY_KEYS)
    _check_keys("probes", raw.get("probes"), _PROBES_KEYS)
    _check_keys("comms", raw.get("comms"), _COMMS_KEYS)
    if raw.get("probes"):
        # value validation (on_divergence, freeze needs enabled) lives in
        # ProbeSpec; running it here fails at load time
        from repro_torch.core.probes import ProbeSpec
        pr = raw["probes"]
        ProbeSpec(enabled=bool(pr.get("enabled", True)), out_dir=pr.get("out_dir"),
                  on_divergence=pr.get("on_divergence", "report"))
    if raw.get("comms"):
        # value validation (pods >= 1) lives in CommsSpec; running it here
        # fails at load time
        from repro_torch.telemetry.comms import CommsSpec
        c = raw["comms"]
        CommsSpec(enabled=bool(c.get("enabled", True)),
                  out_dir=c.get("out_dir"), pods=int(c.get("pods", 1)))

    flkw = {}
    for section in (strat.get("train_params", {}),
                    strat.get("aggregator_params", {}),
                    cons, ds.get("distribution", {}), rt):
        for k, v in (section or {}).items():
            if k in _FL_KEYS:
                flkw[k] = v
    if "strategy" in strat:
        flkw["strategy"] = strat["strategy"]
    fl = FLConfig(**flkw)
    validate_cohort(fl)
    check_ported(raw, fl)
    spec = sweeps.parse_sweep(raw.get("sweep"))
    if spec is not None:
        # every lane must be a job the port runs
        for fl_s in sweeps.expand(fl, spec):
            validate_cohort(fl_s)
            check_ported(raw, fl_s)
            check_client_state(fl_s, get_strategy(fl_s))
            check_ragged(raw, fl_s, get_strategy(fl_s))

    strategy = get_strategy(fl)
    check_client_state(fl, strategy)
    check_ragged(raw, fl, strategy)

    arch = (raw.get("model") or {}).get("arch", "flsim-cnn")
    cfg = get_config(arch)     # small models: ``reduced`` leaves them as-is
    return Job(
        name=raw.get("name", "job"),
        fl=fl, arch=arch, model=model_zoo.build(cfg),
        strategy=strategy,
        topology=get_topology(fl.topology, fl.gossip_steps),
        dataset=make_dataset(raw, fl, cfg),
        ledger=get_ledger(fl.blockchain),
        fault=make_fault(raw, fl),
        raw=raw,
        sweep=spec,
    )
