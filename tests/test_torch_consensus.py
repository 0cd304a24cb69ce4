"""Multi-worker consensus (``repro_torch/core/consensus.py``) and its wiring
into the rounds, against the JAX package and the port's own contracts, on
the CPU.

- Each consensus function against the JAX one on the same stacked numpy
  inputs: median and trimmed mean at rtol 1e-6; majority_digest's winner
  (the two packages project with other random matrices, so the digests
  differ, but groups of exact copies vote the same way).
- With an honest majority (majority_digest at W = 3, median and trimmed
  mean at W = 4, one byzantine worker) every consensus function returns
  the honest aggregate exactly, so a round is bitwise the W = 1 round
  inside the port, and matches the JAX package's consensus round at the
  tolerances of ``tests/test_torch_slice.py``: loss rtol 1e-5, params atol
  1e-5 / rtol 1e-4; on int8 at most 1e-3 of the entries (and at least one)
  may differ by more, each by at most one quantum (the largest block scale
  the rounds sent): an int8 rounding flip.
- The poisoned path draws other values than threefry's, so it is held by
  its own properties: deterministic, different per worker and per round,
  and a W = 2 tie picks the poisoned worker 0. (The same bits on the CPU and
  the card: ``tests/test_torch_gpu.py``.)
- The two launch modules on the CPU; the byzantine example's losses
  against the JAX example's from the same weights at rtol 1e-5.
"""
import functools
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import FLConfig as JFLConfig
from repro.configs.flsim_small import FLSIM_CNN as J_CNN
from repro.core import consensus as jcons
from repro.core import determinism as jdet
from repro.core.rounds import build_spatial_round as j_build_spatial_round
from repro.core.rounds import build_temporal_round as j_build_temporal_round
from repro.core.rounds import init_state as j_init_state
from repro.core.strategies import get_strategy as j_get_strategy
from repro.models.small import SmallModel as JSmallModel
from repro.sharding.axes import AxisCtx
from repro_torch.configs.base import FLConfig, get_config
from repro_torch.core import consensus, determinism, rounds
from repro_torch.core.consensus import MultiWorkerAggregator, poison
from repro_torch.core.strategies import get_strategy
from repro_torch.interop import params_from_numpy, state_from_numpy, to_numpy
from repro_torch.models.small import SmallModel


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


ROOT = pathlib.Path(__file__).resolve().parents[1]
ROOT_KEY = determinism.root_key(0)
C, STEPS, B, ROUNDS = 4, 2, 4, 3
# honest majority: one byzantine worker out of W
HONEST = {"majority_digest": 3, "median": 4, "trimmed_mean": 4}
# (placement, strategy, compression) of the rounds held to the JAX package,
# each with one consensus function (all three are bitwise W = 1 in the port)
KINDS = {("spatial", "fedavg", "none"): "majority_digest",
         ("spatial", "compressed", "int8"): "median",
         ("temporal", "compressed", "int8"): "trimmed_mean"}


@pytest.fixture(autouse=True)
def _fresh_jax_projections():
    """The JAX package's ``consensus._projection`` is an ``lru_cache`` that
    keeps what its first call made: under ``jax.jit`` a tracer, which a later
    trace then reuses and fails on (a leaked tracer). Each test here and each
    test after it in this process starts with an empty cache."""
    jcons._projection.cache_clear()
    yield
    jcons._projection.cache_clear()


def _stacked(W, seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(W, 37).astype(np.float32),
            "b": rng.randn(W, 3, 5).astype(np.float32)}


# -- each consensus function against the JAX one ------------------------------

@pytest.mark.parametrize("W", [3, 4, 5])
@pytest.mark.parametrize("name", ["median", "trimmed_mean"])
def test_robust_means_match_jax(name, W):
    x = _stacked(W, W)
    want = jcons.CONSENSUS_REGISTRY[name]({k: jnp.asarray(v) for k, v in x.items()}, {})
    got = consensus.CONSENSUS_REGISTRY[name](params_from_numpy(x), {})
    for k in x:
        assert got[k].shape == x[k].shape[1:]
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("W", [3, 4, 5])
@pytest.mark.parametrize("name", ["median", "trimmed_mean"])
def test_robust_means_by_column_chunks_are_the_whole_leaf(name, W, monkeypatch):
    """The coordinate-wise functions take a leaf's columns a chunk at a
    time (``consensus.COLUMNS``; a sort's indices of a whole LM leaf would
    not fit a card): bitwise the whole leaf at once, ragged last chunk too."""
    x = params_from_numpy(_stacked(W, W + 10))
    whole = consensus.CONSENSUS_REGISTRY[name](x, {})
    monkeypatch.setattr(consensus, "COLUMNS", 4)
    chunked = consensus.CONSENSUS_REGISTRY[name](x, {})
    for k in x:
        assert torch.equal(chunked[k], whole[k]), k


@pytest.mark.parametrize("rows", [
    [0, 1, 1],            # W = 3: a pair outvotes a singleton
    [0, 1, 0, 1],         # W = 4: a tie goes to the first worker
    [2, 0, 1, 1, 3],      # W = 5: a pair among singletons
    [0, 1, 2, 1, 2],      # W = 5: two pairs, the first one's first copy
])
def test_majority_digest_winner_matches_jax(rows):
    base = _stacked(max(rows) + 1, 7)
    x = {k: v[rows] for k, v in base.items()}
    want = jcons.majority_digest({k: jnp.asarray(v) for k, v in x.items()}, {})
    got = consensus.majority_digest(params_from_numpy(x), {})
    for k in x:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    counts = np.bincount(rows)
    first = rows.index(int(np.argmax(counts)))     # jnp.argmax: first of the most votes
    assert all(torch.equal(got[k], torch.from_numpy(x[k][first])) for k in x)


def test_median_takes_the_midpoint_at_even_w():
    t = torch.tensor([[1.0], [4.0], [2.0], [10.0]])
    assert consensus.median_select({"t": t}, {})["t"].item() == 3.0
    assert consensus.trimmed_mean({"t": t[:2]}, {})["t"].item() == 2.5   # W <= 2 trim


# -- the nullification table (tests/test_consensus_blockchain.py) -------------

def _agg_delta():
    rng = np.random.RandomState(0)
    return {"w": torch.from_numpy(rng.randn(128).astype(np.float32)),
            "b": torch.ones(4)}


@pytest.mark.parametrize("n_workers,n_byz,nullified", [
    (1, 1, False),   # 1M-0H: single malicious worker poisons the model
    (2, 1, False),   # 1M-1H: tie — the first worker, the poisoned one, wins
    (3, 1, True),    # 1M-2H: honest majority nullifies
    (4, 1, True),    # 1M-3H
])
def test_majority_nullifies_minority_poisoners(n_workers, n_byz, nullified):
    d = _agg_delta()
    out = MultiWorkerAggregator(n_workers, n_byz, "majority_digest").run(d, 1)
    if nullified:
        assert all(torch.equal(out[k], d[k]) for k in d)
    else:
        assert not torch.allclose(out["w"], d["w"], atol=1e-5)


@pytest.mark.parametrize("name", ["median", "trimmed_mean"])
def test_robust_means_nullify_one_poisoner_of_four(name):
    d = _agg_delta()
    out = MultiWorkerAggregator(4, 1, name).run(d, 5)
    assert all(torch.equal(out[k], d[k]) for k in d)


# -- the poisoned path ---------------------------------------------------------

def test_poison_is_deterministic_and_keyed_by_worker_round_and_leaf():
    d = {"a": torch.zeros(300), "b": torch.zeros(300)}
    p = poison(d, 3.0, 11)
    assert all(torch.equal(p[k], poison(d, 3.0, 11)[k]) for k in d)
    assert not torch.equal(p["a"], p["b"])                  # other leaf
    assert not torch.equal(p["a"], poison(d, 3.0, 12)["a"])  # other key
    assert abs(p["a"].std().item() - 3.0) < 0.5
    assert torch.equal(poison(d)["a"], poison(d, 10.0, consensus.POISON_KEY)["a"])
    # worker w of round r draws from fold_in(round_key, w)
    mw = MultiWorkerAggregator(1, 1, "majority_digest")
    out = mw.run(d, 7)
    assert torch.equal(out["a"], poison(d, 3.0, determinism.fold_in(7, 0))["a"])
    assert not torch.equal(out["a"], mw.run(d, 8)["a"])     # other round


def test_digest_is_deterministic_and_sensitive():
    d = _agg_delta()
    assert torch.equal(consensus.digest(d), consensus.digest(d))
    assert consensus.digest(d).shape == (4,)
    assert not torch.allclose(consensus.digest(d), consensus.digest(poison(d, 0.1)),
                              atol=1e-4)
    stacked = {k: torch.stack([v, 2 * v]) for k, v in d.items()}
    # a (W, width) @ (width, P) product sums in another order than one row's
    torch.testing.assert_close(consensus.digest(stacked, lead=1)[0], consensus.digest(d),
                               rtol=1e-6, atol=1e-6)
    assert consensus.digest_nbytes() == jcons.digest_nbytes() == 16


# -- rounds with consensus, against the JAX package and W = 1 ------------------

def _fl_kw(placement, strategy, compression, name=None, W=1):
    kw = dict(n_clients=C, local_steps=STEPS, batch_size=B, client_lr=0.05,
              strategy=strategy, compression=compression, placement=placement)
    if name is not None:
        kw.update(n_workers=W, byzantine_workers=1, consensus=name)
    return kw


def _batches():
    rng = np.random.RandomState(11)
    out = []
    for r in range(ROUNDS):
        x = rng.randn(C, STEPS, B, 32, 32, 3).astype(np.float32)
        y = rng.randint(0, 10, (C, STEPS, B))
        w = rng.uniform(0.5, 2.0, C).astype(np.float32)
        w[r % C] = 0.0                       # a masked client each round
        out.append((x, y, w))
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(kind):
    """Three chained JAX rounds of ``kind`` with its consensus function;
    returns the initial state and per-round (state, loss) as numpy."""
    placement, strategy, compression = kind
    name = KINDS[kind]
    jfl = JFLConfig(**_fl_kw(*kind, name, HONEST[name]))
    jcfg = J_CNN.replace(d_model=8, d_ff=16)
    jm, jstrat = JSmallModel(jcfg, "cnn"), j_get_strategy(jfl)
    build = (j_build_spatial_round(jm, jstrat, jfl) if placement == "spatial"
             else j_build_temporal_round(jm, jstrat, jfl, jcfg))
    jround = jax.jit(lambda s, b, w, k: build(AxisCtx(), s, b, w, k))
    jcons._projection.cache_clear()          # see _fresh_jax_projections
    jstate = j_init_state(jm, jstrat, jfl, jdet.root_key(0), n_clients_local=C)
    init = jax.tree.map(np.asarray, jstate)
    out = []
    for r, (x, y, w) in enumerate(_batches()):
        jstate, met = jround(jstate, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                             jnp.asarray(w), jdet.round_key(jdet.root_key(0), r))
        out.append((jax.tree.map(np.asarray, jstate), float(met["loss"])))
    return init, out


def _port_run(kind, name, W, init, monkeypatch):
    """The port's three rounds of ``kind`` from the JAX package's initial
    state; returns per-round (state, loss) and the largest block scale sent."""
    placement = kind[0]
    fl = FLConfig(**_fl_kw(*kind, name, W))
    m = SmallModel(get_config("flsim-cnn").replace(d_model=8, d_ff=16), "cnn")
    strat = get_strategy(fl)
    build = (rounds.build_spatial_round if placement == "spatial"
             else rounds.build_temporal_round)
    pround = build(m, strat, fl)
    scales = [0.0]
    agg = rounds.ops.quant_aggregate

    def recording(q, s, w):
        scales.append(float(s.max()))
        return agg(q, s, w)
    monkeypatch.setattr(rounds.ops, "quant_aggregate", recording)
    state = state_from_numpy(init)
    out = []
    for r, (x, y, w) in enumerate(_batches()):
        state, met = pround(state, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                            torch.from_numpy(w), determinism.round_key(ROOT_KEY, r))
        out.append((to_numpy(state), float(met["loss"])))
    return out, max(scales)


def _assert_close_but_flips(got, want, quantum, int8):
    outside = total = 0
    for k, v in want.items():
        diff = np.abs(got[k] - v)
        assert (diff <= quantum + 1e-5 + 1e-4 * np.abs(v)).all(), k
        outside += int((diff > 1e-5 + 1e-4 * np.abs(v)).sum())
        total += diff.size
    assert outside <= (max(1, 1e-3 * total) if int8 else 0), (outside, total)


@pytest.mark.parametrize("kind", list(KINDS), ids=["-".join(k) for k in KINDS])
def test_consensus_rounds_match_jax(kind, monkeypatch):
    name = KINDS[kind]
    init, want = _jax_run(kind)
    got, quantum = _port_run(kind, name, HONEST[name], init, monkeypatch)
    int8 = kind[2] == "int8"
    for (jstate, jloss), (state, loss) in zip(want, got):
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        _assert_close_but_flips(state["params"], jstate["params"], quantum, int8)
        if kind[0] == "spatial" and int8:
            _assert_close_but_flips(state["clients"]["residual"],
                                    jstate["clients"]["residual"], quantum, int8)


@pytest.mark.parametrize("name", list(HONEST))
@pytest.mark.parametrize("kind", [("spatial", "fedavg", "none"),
                                  ("spatial", "compressed", "int8"),
                                  ("temporal", "fedavg", "none"),
                                  ("temporal", "compressed", "int8")],
                         ids=lambda k: "-".join(k))
def test_honest_majority_is_bitwise_one_worker(kind, name, monkeypatch):
    init, _ = _jax_run(("spatial", "fedavg", "none"))     # the same initial weights
    one, _ = _port_run(kind, None, 1, init, monkeypatch)
    many, _ = _port_run(kind, name, HONEST[name], init, monkeypatch)
    for (s1, l1), (sw, lw) in zip(one, many):
        assert l1 == lw
        for k, v in s1["params"].items():
            np.testing.assert_array_equal(sw["params"][k], v, err_msg=k)


def test_a_two_worker_tie_takes_the_poisoned_aggregate(monkeypatch):
    init, _ = _jax_run(("spatial", "fedavg", "none"))
    kind = ("spatial", "fedavg", "none")
    one, _ = _port_run(kind, None, 1, init, monkeypatch)
    tie, _ = _port_run(kind, "majority_digest", 2, init, monkeypatch)
    assert one[0][1] == tie[0][1]                 # round 0 trains from the same weights
    assert all(np.isfinite(l) for _, l in tie) and tie[-1][1] != one[-1][1]


# -- the launch modules ----------------------------------------------------------

def _load_example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parse_losses(text):
    return [float(line.split("loss ")[1].split()[0]) for line in text.splitlines()
            if line.startswith("round ")]


def test_byzantine_launch_matches_the_jax_example(capsys, monkeypatch):
    from repro_torch.launch import byzantine
    example = _load_example("byzantine_consensus")
    init = {}

    def recording_init(*a, **kw):                 # keep the JAX example's weights
        init["state"] = j_init_state(*a, **kw)
        return init["state"]
    monkeypatch.setattr(example, "init_state", recording_init)
    jlosses = []

    def recording_jit(fn):                        # the JAX example's unrounded losses
        prog = jax.jit(fn)

        def run(*a):
            state, m = prog(*a)
            jlosses.append(float(m["loss"]))
            return state, m
        return run
    monkeypatch.setattr(example, "jax", types.SimpleNamespace(jit=recording_jit,
                                                              tree=jax.tree))
    example.main()
    want = capsys.readouterr().out
    monkeypatch.setattr(byzantine, "init_state", lambda *a, **kw: state_from_numpy(
        jax.tree.map(np.asarray, init["state"])))
    losses, ledger = byzantine.main(["--device", "cpu"])
    got = capsys.readouterr().out
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert len(jlosses) == 4 and _parse_losses(got) == _parse_losses(want)
    assert ledger.verify() and len(ledger.blocks()) == 21
    assert {k: round(v, 2) for k, v in ledger.reputation.items()} == \
        {"worker_0": 0.0, "worker_1": 1.4, "worker_2": 1.4}
    tail = [line for line in want.splitlines() if not line.startswith("round ")]
    assert [line for line in got.splitlines() if not line.startswith("round ")] == tail


def test_gossip_launch_runs_on_the_cpu(capsys):
    from repro_torch.launch import gossip
    losses, divs = gossip.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("gossip OK") and len(losses) == 6
    assert losses[-1] < losses[0] and all(0 < d < 1e-2 for d in divs)
