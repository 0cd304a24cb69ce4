"""Each driver runs a whole cell end to end on the CPU at a reduced size,
through the harness, with the kernels' plain versions: set-up, the window,
the traced sub-window, the reference and the comparison; and with the
timed path broken underneath, the comparison comes out false."""
import math

import pytest
import torch

from portbench import harness

CELLS = ("cnn_sweep8_int8", "yi34b_l4_int8")


def run(tiny, name, trace=False, seed=2**31 + 7):
    cell, cfg, driver = tiny(name)
    return harness.run_cell(cell, cfg, driver, seed, 0.5, trace, torch.device("cpu"),
                            0.0, harness.benchmark(), name)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_is_correct(tiny, name):
    out = run(tiny, name)
    assert out["correct"], out["checks"]
    e2e, _ = harness.cell_metrics(harness.benchmark(), name)
    assert set(out["metrics"]) == {m["name"] for m in e2e}
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
    assert list(out)[-1] == "checks" and out["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_what_the_cpu_has(tiny, name):
    out = run(tiny, name, trace=True)
    assert out["correct"], out["checks"]
    # no device here: the device readers find nothing and stay silent
    _, layer = harness.cell_metrics(harness.benchmark(), name)
    assert set(out["metrics"]) <= {m["name"] for m in layer}
    assert not any(k.startswith(("idle_share", "attn_", "rmsnorm_", "quant_"))
                   for k in out["metrics"])
    assert out["device"]["window_s"] > 0 and "breakdown" in out


def _unchanged(build):
    def wrapped(*a, **kw):
        fn = build(*a, **kw)

        def same(state, *args, **kws):
            _, metrics = fn(state, *args, **kws)
            return state, metrics
        return same
    return wrapped


def _half_lm(build):
    def wrapped(*a, **kw):
        fn = build(*a, **kw)

        def half(state, batch, *args, **kws):
            B = batch["tokens"].shape[2]
            return fn(state, {k: v[:, :, :B // 2] for k, v in batch.items()}, *args, **kws)
        return half
    return wrapped


def _altered(build):
    """The round's loss reported 1 % high: an answer altered where made."""
    def wrapped(*a, **kw):
        fn = build(*a, **kw)

        def alter(state, *args, **kws):
            state, metrics = fn(state, *args, **kws)
            return state, dict(metrics, loss=metrics["loss"] * 1.01)
        return alter
    return wrapped


def _half_gather(gather):
    def half(staged, round_key, batch_size, n_steps):
        out = gather(staged, round_key, batch_size, n_steps)
        return {k: v[:, :, :batch_size // 2] for k, v in out.items()}
    return half


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_round_is_not_correct(tiny, monkeypatch, name, fault):
    from repro_torch.core import rounds
    from repro_torch.data import pipeline
    if name == "yi34b_l4_int8":
        wrap = {"unchanged": _unchanged, "half_batch": _half_lm, "altered": _altered}[fault]
        monkeypatch.setattr(rounds, "build_temporal_round", wrap(rounds.build_temporal_round))
    elif fault == "half_batch":
        monkeypatch.setattr(pipeline, "gather_client_batches",
                            _half_gather(pipeline.gather_client_batches))
    else:
        wrap = {"unchanged": _unchanged, "altered": _altered}[fault]
        monkeypatch.setattr(rounds, "build_spatial_round", wrap(rounds.build_spatial_round))
    out = run(tiny, name)
    assert not out["correct"], out["checks"]
