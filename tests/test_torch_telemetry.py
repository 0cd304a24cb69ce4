"""The port's flight recorder (``telemetry/recorder.py``), its exporter and
report (``telemetry/trace.py``) and the executor's spans and counters, on
the CPU.

- The recorder writes the JAX package's ``telemetry.jsonl`` schema: the
  JAX package's ``trace.report`` and ``to_chrome_trace`` read the port's
  file, and the port's ``to_chrome_trace`` gives the JAX package's output
  on the same events (exactly: host Python on the same dicts).
- Telemetry and probes on == off, bitwise, for the spatial, temporal and
  async round loops and a campaign: the recorder only reads the host clock.
- The spans and counters a run records, and the CLI.
- The layer spans inside a launch (``recorder.layer_span``): inert off, on
  under ``torch.profiler`` or an enabled recorder's launch, nested under
  ``local_train`` though autograd runs the backwards, their counters exact,
  drained into a ``layers`` counter per launch, and merged with the
  recorder's ``torch_profile`` captures on one clock.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.telemetry import trace as jtrace
from repro_torch.configs.base import FLConfig, get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.core import determinism
from repro_torch.core.jobs import load_job
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train_fl_lm
from repro_torch.models.small import SmallModel
from repro_torch.runtime.campaign import CampaignExecutor
from repro_torch.runtime.executor import Executor
from repro_torch.runtime.faults import cohort_mask
from repro_torch.telemetry import (FlightRecorder, layer_times, read_events,
                                   reset_layer_times)
from repro_torch.telemetry import trace


@pytest.fixture(autouse=True)
def one_thread():
    """Every test here on one torch intra-op thread: the suite runs in
    several processes that share the cores, and with a thread per core in
    each, torch's many small CPU ops crawl (six of the port's test files took
    426 s under six processes against 75 s on one thread each)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SPANS = {"scaffold", "stage_data", "init_state", "restore", "chunk", "launch",
         "finish_chunk", "probe_flush", "comms_flush", "checkpoint_save"}
COUNTERS = {"staged_bytes", "host", "program_cost", "quant_agg", "programs",
            "comms_total", "probe:update_norm", "comms:sim_time_s", "layers"}
# the layer spans a round records, and the span each sits in
LAYER_PARENTS = {"local_train": None, "send.pack": "local_train",
                 "server.aggregate": None, "server.update": None,
                 "attn.bwd": "local_train", "rmsnorm.bwd": "local_train"}


def _raw(mode="sync", rounds=2, chunk=1, out=None, probes=True, seed=5, sweep=None,
         strategy="compressed", compression="int8", **train):
    tp = {"n_clients": 4, "local_steps": 2, "batch_size": 4, "client_lr": 0.1,
          "rounds": rounds, "seed": seed, "rounds_per_launch": chunk,
          "compression": compression, "checkpoint_every": 1}
    if mode == "async":
        tp.update(mode="async", async_buffer=3, max_staleness=4, staleness_exponent=0.5)
    tp.update(train)
    raw = {"name": "telemetry", "model": {"arch": "flsim-cnn"},
           "dataset": {"dataset": "synthetic_vision", "n_items": 128},
           "strategy": {"strategy": strategy, "train_params": tp},
           "runtime": {"straggler_prob": 0.2, "duration_sigma": 0.25}}
    if out is not None:
        raw["telemetry"] = {"out_dir": str(out)}
        raw["comms"] = {"enabled": True}
        if probes:
            raw["probes"] = {"enabled": True}
    if sweep:
        raw["sweep"] = sweep
    return raw


def _job(raw):
    job = load_job(raw)
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _flat(v)]
    return [tree]


def _bitwise(a, b):
    fa, fb = _flat(a), _flat(b)
    return len(fa) == len(fb) and all(torch.equal(x, y) for x, y in zip(fa, fb))


@pytest.mark.parametrize("mode,train", [("sync", {}),
                                        ("sync", {"placement": "temporal"}),
                                        ("async", {}),
                                        ("async", {"async_buffer": 0})])
def test_telemetry_and_probes_on_equal_off_bitwise(tmp_path, mode, train):
    runs = []
    for out in (None, tmp_path / "on"):
        ex = Executor(_job(_raw(mode, out=out, **train)), device="cpu",
                      ckpt_dir=str(tmp_path / ("ck" if out else "ck_off"))).scaffold()
        state, logger = ex.run()
        runs.append((state, logger.series("loss"), ex))
    (s0, l0, off), (s1, l1, on) = runs
    assert l0 == l1 and _bitwise(s0, s1)
    assert not off.recorder.enabled and on.recorder.enabled and len(on.probe_rows) == 2
    # the on run's layer spans were on: one ``layers`` counter a launch
    layers = [e["values"] for e in on.recorder.events if e.get("name") == "layers"]
    assert len(layers) == 2 and all({"local_train", "send.pack"} <= set(v["spans"])
                                    for v in layers)


def test_campaign_telemetry_and_probes_on_equal_off_bitwise(tmp_path):
    runs = []
    for out in (None, tmp_path / "on"):
        ex = CampaignExecutor(_job(_raw(out=out, sweep={"seed": [0, 1]})),
                              device="cpu").scaffold()
        ex.run()
        runs.append(ex)
    off, on = runs
    assert _bitwise(off.state, on.state) and off.results[-1]["loss"] == on.results[-1]["loss"]
    events = read_events(tmp_path / "on")
    layers = [e["values"] for e in events if e.get("name") == "layers"]
    assert len(layers) == 2 and all(set(v["spans"]) == {
        "local_train", "send.pack", "server.aggregate", "server.update"} for v in layers)
    assert sum(v["counters"]["clients_trained"] for v in layers) == 2 * 4 * 2
    occ = [e for e in events if e.get("name") == "lane_occupancy"]
    assert occ and occ[0]["values"] == {"alive": 2, "total": 2}
    lanes = {k for e in events if e.get("name") == "probe:update_norm"
             for k in e["values"]}
    assert lanes == {"lane0", "lane1"}


def test_spans_and_counters_of_a_run(tmp_path):
    ex = Executor(_job(_raw(out=tmp_path)), device="cpu", ckpt_dir=str(tmp_path / "ck"))
    ex.scaffold().run()
    ex.recorder.close()
    events = read_events(tmp_path)
    assert events[0] == {**events[0], "kind": "meta", "schema": 1, "run": "telemetry",
                         "unit": "us", "clock": "perf_counter_ns"}
    names = {e["name"] for e in events if e["kind"] == "span"}
    assert SPANS <= names, SPANS - names
    counters = {e["name"]: e["values"] for e in events if e["kind"] == "counter"}
    assert COUNTERS <= set(counters), COUNTERS - set(counters)
    assert counters["quant_agg"] == {"calls": 2, "batched_fallbacks": 0}
    assert counters["programs"] == {"compiled": 1}
    cost = counters["program_cost"]
    assert cost["program"] == "('sync', 1)" and cost["flops"] > 0
    assert "bytes_accessed" not in cost
    launches = [e for e in events if e["kind"] == "span" and e["name"] == "launch"]
    assert [sp["attrs"]["quant_agg_traces"] for sp in launches] == [1, 1]
    layers = [e for e in events if e["kind"] == "counter" and e["name"] == "layers"]
    assert len(layers) == len(launches)                    # drained once a launch
    for e in layers:
        assert set(e["values"]["spans"]) == set(LAYER_PARENTS) - {"attn.bwd", "rmsnorm.bwd"}
        assert e["values"]["spans"]["local_train"]["count"] == 1
        assert e["values"]["counters"]["clients_trained"] == 4
    report = trace.report(str(tmp_path))
    assert "launch%" in report and "local_train" in report \
        and "counter" in report and "clients_weighted" in report
    assert all(sp["attrs"]["compile_delta"] == 0 for sp in launches)   # CPU: no kernel builds
    spans = {e["id"]: e for e in events if e["kind"] == "span"}
    for sp in spans.values():                       # nesting: children inside parents
        if sp["parent"] is not None:
            par = spans[sp["parent"]]
            assert par["depth"] == sp["depth"] - 1 and par["t0_us"] <= sp["t0_us"]


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_the_jax_package_reads_the_ports_telemetry(tmp_path, mode):
    """The port's telemetry.jsonl through the JAX package's report and
    exporter; the port's exporter gives the JAX package's trace on the same
    events."""
    ex = Executor(_job(_raw(mode, out=tmp_path)), device="cpu").scaffold()
    ex.run()
    ex.recorder.close()
    events = read_events(tmp_path)
    jreport = jtrace.report(str(tmp_path))
    assert jreport.startswith("== telemetry report: telemetry")
    # the port's report is the JAX package's, then the port's layer table
    table = trace.layer_table(events)
    assert table and trace.report(str(tmp_path)) == "\n".join([jreport] + table)
    assert trace.to_chrome_trace(events) == jtrace.to_chrome_trace(events)
    assert "     run         2" in jreport                   # the launch table row


def test_chrome_trace_and_cli(tmp_path):
    ex = Executor(_job(_raw("async", out=tmp_path)), device="cpu").scaffold()
    ex.run()
    ex.recorder.close()
    out = trace.export(tmp_path)
    doc = json.loads(out.read_text())
    phases = {e["ph"] for e in doc["traceEvents"]}
    assert phases == {"M", "X", "C"}
    env = {"PYTHONPATH": "src"}
    res = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.trace", "report",
                          str(tmp_path)], capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode == 0 and "category" in res.stdout
    res = subprocess.run([sys.executable, "-m", "repro_torch.telemetry.trace",
                          str(tmp_path / "missing")], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 1 and "no telemetry.jsonl" in res.stderr


def test_profile_chunks_exports_a_torch_profile(tmp_path):
    raw = _raw(out=tmp_path, probes=False)
    raw["telemetry"]["profile_chunks"] = [1]
    ex = Executor(_job(raw), device="cpu").scaffold()
    ex.run()
    assert [p.name for p in ex.recorder.profile_paths] == ["launch1.json"]
    trace_doc = json.loads(ex.recorder.profile_paths[0].read_text())
    assert trace_doc["traceEvents"]


def test_disabled_recorder_is_inert(tmp_path):
    rec = FlightRecorder(out_dir=tmp_path, enabled=False)
    with rec.span("x") as sp:
        sp.attrs.update(a=1)
    rec.counter("c", v=1)
    rec.flush()
    assert rec.events == [] and not (tmp_path / "telemetry.jsonl").exists()
    assert not FlightRecorder.from_job(_job(_raw())).enabled


def test_recorder_events_and_torn_tail(tmp_path):
    rec = FlightRecorder(out_dir=tmp_path, run_name="r")
    with rec.span("outer", track="t", k=1):
        with rec.span("inner", track="t"):
            rec.counter("c", track="t", v=2)
    rec.close()
    events = read_events(tmp_path)
    assert [e["kind"] for e in events] == ["meta", "counter", "span", "span"]
    inner, outer = events[2], events[3]
    assert (inner["name"], inner["parent"], inner["depth"]) == ("inner", outer["id"], 1)
    path = tmp_path / "telemetry.jsonl"
    path.write_text(path.read_text() + '{"kind": "span", "na')
    assert len(read_events(tmp_path)) == 4
    (tmp_path / "e").mkdir()
    (tmp_path / "e" / "telemetry.jsonl").write_text("")
    with pytest.raises(ValueError, match="empty"):
        read_events(tmp_path / "e")


def test_telemetry_section_is_validated():
    raw = _raw()
    raw["telemetry"] = {"out_dri": "x"}
    with pytest.raises(KeyError, match="did you mean 'out_dir'"):
        load_job(raw)
    raw["telemetry"] = {"enabled": False}
    assert not FlightRecorder.from_job(load_job(raw)).enabled


def test_host_usage_is_shared_by_the_logger_and_the_recorder(tmp_path):
    from repro_torch.metrics import logger
    ex = Executor(_job(_raw(out=tmp_path)), device="cpu").scaffold()
    _, lg = ex.run()
    host = [e for e in ex.recorder.events if e.get("name") == "host"]
    assert set(host[0]["values"]) == set(logger.host_usage()) == {"cpu_s", "max_rss_mb"}
    assert {"cpu_s", "max_rss_mb"} <= set(lg.rows[0])
    assert np.isfinite(lg.rows[-1]["loss"])


def test_program_cost_counts_a_grouped_conv_backward_once():
    """The clients' vmapped convs are grouped convs: their weight gradient
    is counted once per group, as the loop over the clients counts it."""
    import torch.nn.functional as F
    from torch.func import grad, vmap
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.runtime.executor import _conv_backward_flop
    x, w = torch.randn(6, 2, 4, 8, 8), torch.randn(6, 5, 4, 3, 3)
    f = lambda w, x: grad(lambda w, x: F.conv2d(x, w, padding=1).sum(),  # noqa: E731
                          argnums=(0, 1))(w, x)
    mapping = {torch.ops.aten.convolution_backward: _conv_backward_flop}
    with FlopCounterMode(display=False, custom_mapping=mapping) as lanes:
        vmap(f)(w, x)
    with FlopCounterMode(display=False) as loop:
        for c in range(6):
            f(w[c], x[c])
    assert lanes.get_total_flops() == loop.get_total_flops() > 0


# -- layer spans ---------------------------------------------------------------
def _lm_round():
    """One temporal int8 round of reduced yi-34b, two clients of two local
    steps: () -> (state, metrics), from the same state each call."""
    fl = FLConfig(strategy="compressed", compression="int8", error_feedback=False,
                  n_clients=4, cohort=2, client_lr=0.05)
    _, round_fn, state = train_fl_lm.setup(reduced_config(get_config("yi-34b")), fl, "cpu")
    batch = train_fl_lm.round_batch(SyntheticLM(vocab=512, seed=0), 0, clients=4, cohort=2,
                                    batch=2, seq=16, local_steps=2, device="cpu")
    w = torch.ones((2,))
    return lambda: round_fn(state, batch, w, determinism.round_key(determinism.root_key(0), 0))


def _campaign():
    """A 2-lane int8 campaign, scaffolded: () -> the lanes' state after one
    chunk of 2 rounds, with the chunk's cohort masks for the counters."""
    ex = CampaignExecutor(_job(_raw(rounds=2, chunk=2, cohort=2, sweep={"seed": [0, 1]})),
                          device="cpu").scaffold()
    fl = ex.job.fl
    masks = np.stack([[cohort_mask(f, r, fl.n_clients, fl.cohort or fl.n_clients,
                                   fl.straggler_overprovision) for r in range(2)]
                      for f in ex.faults])

    def run():
        ex.run()
        return ex.state
    return run, masks


def test_layer_spans_off_are_inert(monkeypatch):
    """No profiler and no recorder: a span site makes no range and no event,
    and nothing is kept."""
    import torch.autograd.profiler as autograd_profiler
    made = {"range": 0, "event": 0}
    record_function, event = autograd_profiler.record_function, torch.cuda.Event

    def counting_range(name, *a, **kw):
        made["range"] += name.startswith("repro_torch.")
        return record_function(name, *a, **kw)

    def counting_event(*a, **kw):
        made["event"] += 1
        return event(*a, **kw)
    monkeypatch.setattr(autograd_profiler, "record_function", counting_range)
    monkeypatch.setattr(torch.cuda, "Event", counting_event)
    reset_layer_times()
    lm = _lm_round()
    lm()
    _campaign()[0]()
    assert made == {"range": 0, "event": 0}
    assert layer_times() == {"spans": {}, "counters": {}}
    with torch.profiler.profile():
        lm()
    assert made["range"] > 0 and layer_times()["spans"]       # the counters count
    reset_layer_times()


@pytest.mark.parametrize("program", ["lm_temporal_int8", "campaign_int8"])
def test_layer_spans_nest_under_the_profiler(program):
    """Every span of the round, each under the span that waits for it: the
    backwards autograd runs sit under ``local_train``; the counters count
    every client row of every lane and round, and the kept rows."""
    reset_layer_times()
    if program == "lm_temporal_int8":
        run, masks = _lm_round(), None
        want = set(LAYER_PARENTS)
    else:
        run, masks = _campaign()
        want = set(LAYER_PARENTS) - {"attn.bwd", "rmsnorm.bwd"}
    with torch.profiler.profile() as prof:
        run()
    t = layer_times()
    reset_layer_times()
    assert set(t["spans"]) == want
    for name, sp in t["spans"].items():
        assert sp["parents"] == {LAYER_PARENTS[name]: sp["count"]}, name
        assert sp["device_s"] == sp["host_s"] > 0          # the CPU: host intervals
        assert sp["self_device_s"] <= sp["device_s"]
    ranges = {e.name for e in prof.events() if e.name.startswith("repro_torch.")}
    assert ranges == {"repro_torch." + n for n in want}
    if masks is None:
        cfg = reduced_config(get_config("yi-34b"))
        # 2 clients x 2 local steps x the layers' attention; every norm twice a layer + 1
        assert t["spans"]["local_train"]["count"] == 2 == t["spans"]["send.pack"]["count"]
        assert t["spans"]["attn.bwd"]["count"] == 4 * cfg.n_layers
        assert t["spans"]["rmsnorm.bwd"]["count"] == 4 * (2 * cfg.n_layers + 1)
        assert t["spans"]["server.aggregate"]["count"] == 1
        assert not t["counters"]
    else:
        S, n, C = masks.shape
        assert t["spans"]["local_train"]["count"] == n           # all lanes in one call
        assert t["counters"] == {"clients_trained": S * n * C,
                                 "clients_weighted": int(np.count_nonzero(masks))}
        assert 0 < np.count_nonzero(masks) < S * n * C


def test_export_puts_profile_captures_on_the_recorders_clock(tmp_path):
    """A ``profile_chunks`` capture merged into ``trace.json``: its
    ``repro_torch.local_train`` ranges fall inside the recorder's span of the
    launch it captured."""
    raw = _raw(out=tmp_path, probes=False)
    raw["telemetry"]["profile_chunks"] = [1]
    ex = Executor(_job(raw), device="cpu").scaffold()
    ex.run()
    ex.recorder.close()
    meta = read_events(tmp_path)[0]
    assert {"origin_ns", "origin_wall_ns"} <= set(meta)
    doc = json.loads(trace.export(tmp_path).read_text())["traceEvents"]
    launches = {e["args"]["ordinal"]: e for e in doc
                if e.get("ph") == "X" and e["name"] == "launch"}
    ranges = [e for e in doc if e.get("ph") == "X" and e["name"] == "repro_torch.local_train"]
    assert len(launches) == 2 and ranges
    one, zero = launches[1], launches[0]
    for r in ranges:
        assert one["ts"] <= r["ts"] and r["ts"] + r["dur"] <= one["ts"] + one["dur"]
        assert r["ts"] > zero["ts"] + zero["dur"]
    names = {e["args"]["name"] for e in doc if e.get("ph") == "M"
             and e["name"] == "process_name"}
    assert any(n.startswith("launch1 ") for n in names)


@pytest.mark.parametrize("lanes", [False, True])
def test_clients_trained_counts_the_rows_the_round_gathers(monkeypatch, lanes):
    """A round that trains fewer client rows than are staged moves
    ``clients_trained`` by itself: the rows are counted where the round
    gathers them, in every lane, not taken from the configuration."""
    from repro_torch.core import rounds
    from repro_torch.data import pipeline
    gather, build = pipeline.gather_client_batches, rounds.build_temporal_round
    monkeypatch.setattr(pipeline, "gather_client_batches",
                        lambda *a: {k: v[:2] for k, v in gather(*a).items()})

    def two_rows(*a, **kw):
        fn = build(*a, **kw)
        return lambda st, batch, w, rng, hyper=None: fn(st, batch, w[:2], rng, hyper)
    monkeypatch.setattr(rounds, "build_temporal_round", two_rows)
    raw = _raw(rounds=2, chunk=2, placement="temporal",
               sweep={"seed": [0, 1]} if lanes else None)
    ex = (CampaignExecutor if lanes else Executor)(_job(raw), device="cpu").scaffold()
    reset_layer_times()
    with torch.profiler.profile():
        ex.run()
    counters = layer_times()["counters"]
    reset_layer_times()
    S = 2 if lanes else 1
    assert ex.job.fl.n_clients == 4
    assert counters["clients_trained"] == S * 2 * 2          # lanes x rounds x rows gathered
