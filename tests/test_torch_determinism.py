"""The port's randomness (``repro_torch/core/determinism.py``): fixed known
values of the hash, the per-client batch draw as a lane of the batched one,
and chunked == unchunked runs, bitwise, for the strategies whose state or
draws depend on the client and the round (SCAFFOLD's variates, gossiped
per-client models, DP noise).

The hash is splitmix64 (Steele, Lea, Flood, "Fast splittable pseudorandom
number generators", OOPSLA 2014); its first output from seed 0 is the
published 0xe220a8397b1dcdaf. Everything here is bitwise, but for the
normals' two halves, which are held to numpy's ``log`` and ``cos`` over
every one of their 2**24 inputs.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import determinism as d
from repro_torch.core.jobs import load_job
from repro_torch.data.pipeline import (SyntheticVision, gather_client_batches,
                                       gather_one_client_batch, stage_partitions)
from repro_torch.models.small import SmallModel
from repro_torch.runtime.executor import Executor


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


U64 = (1 << 64) - 1


def test_hash_gives_its_known_values():
    assert d.root_key(0) == 0xE220A8397B1DCDAF          # splitmix64(0), first output
    assert d.root_key(1) == 0x910A2DEC89025CC1
    rk = d.round_key(d.root_key(0), 3)
    assert d.client_key(rk, 5) == 0xC0FC79E6CD72CCD5
    assert d.batch_key(rk, 5) == 0x59A8C71BCD479656
    bits = [b & U64 for b in d.draw_bits(d.root_key(0), torch.arange(4)).tolist()]
    assert bits == [0xA706DD2F4D197E6F, 0xB382A305F4414F5E,
                    0x631A9154FBABF717, 0xA80ABA8C86640906]
    assert d.uniform_index(d.root_key(0), torch.arange(8), 1000).tolist() == \
        [652, 701, 387, 656, 787, 146, 778, 265]


def test_tensor_hash_is_the_integer_hash():
    rng = np.random.RandomState(0)
    vals = [0, 1, (1 << 63) - 1, 1 << 63, U64] + [int(v) for v in
                                                  rng.randint(0, 2**63, 200, dtype=np.int64)]
    t = torch.tensor([d.signed(v) for v in vals], dtype=torch.int64)
    assert [v & U64 for v in d.mix_tensor(t).tolist()] == [d._mix(v) for v in vals]
    key = d.root_key(9)
    assert [v & U64 for v in d.fold_in_tensor(key, torch.arange(50)).tolist()] == \
        [d.fold_in(key, i) for i in range(50)]
    assert [v & U64 for v in d.client_keys(key, 6, "cpu").tolist()] == \
        [d.client_key(key, c) for c in range(6)]
    assert [v & U64 for v in d.batch_keys(key, 6, "cpu").tolist()] == \
        [d.batch_key(key, c) for c in range(6)]
    assert [v & U64 for v in d.draw_bits(key, torch.arange(20)).tolist()] == \
        [d._mix((key + i * d._GAMMA) & U64) for i in range(20)]


def test_normal_is_box_muller_of_the_bits():
    key = d.root_key(4)
    bits = [b & U64 for b in d.draw_bits(key, torch.arange(64)).tolist()]
    want = [math.sqrt(-2 * math.log(((b >> 40) + 1) * 2.0 ** -24))
            * math.cos(2 * math.pi * ((b >> 16) & 0xFFFFFF) * 2.0 ** -24) for b in bits]
    np.testing.assert_allclose(d.normal(key, torch.arange(64)).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_normal_calls_no_transcendental_function(monkeypatch):
    """``normal`` runs with ``torch.log``, ``log1p``, ``exp``, ``cos`` and
    ``sin`` made to raise: its value comes from correctly rounded
    operations only, so it has the same bits on any CPU and on the card."""
    want = d.normal(d.root_key(4), torch.arange(4096))
    for name in ("log", "log1p", "exp", "cos", "sin"):
        def boom(*a, _name=name, **kw):
            raise AssertionError(f"normal called torch.{_name}")
        monkeypatch.setattr(torch, name, boom)
    got = d.normal(d.root_key(4), torch.arange(4096))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_normals_log_part_is_within_two_ulp_of_numpy_over_every_input():
    """``log(u1)``, u1 = (k + 1) 2**-24, for all 2**24 values of k against
    numpy's f64 ``log`` of the same (exact) u1, in four slices."""
    n = 1 << 22
    for lo in range(0, 1 << 24, n):
        k = np.arange(lo, lo + n, dtype=np.int64)
        got = d._log_u1(torch.from_numpy(k)).numpy()
        want = np.log((k + 1).astype(np.float64) * 2.0 ** -24)
        assert (np.abs(got - want) <= 2 * np.spacing(np.abs(want))).all()
    assert d._log_u1(torch.tensor([(1 << 24) - 1])).item() == 0.0     # u1 = 1


def test_normals_cos_part_is_within_4e_16_of_numpy_over_every_input():
    """``cos(2 pi u2)``, u2 = j 2**-24, for all 2**24 values of j within
    4e-16 (absolute: cos crosses zero) of numpy's ``cos``, in four slices.
    numpy takes the angle in extended precision (``np.longdouble``) where
    the platform has it, else its f64 ``cos`` and ``sin`` of the angle
    within the quadrant (exact quadrant from j's top bits): the f64 angle
    ``2 pi j 2**-24`` alone is off by up to 4.4e-16, which would move its
    cosine as far."""
    n = 1 << 22
    wide = np.finfo(np.longdouble).nmant >= 63
    for lo in range(0, 1 << 24, n):
        j = np.arange(lo, lo + n, dtype=np.int64)
        got = d._cos_2pi_u2(torch.from_numpy(j)).numpy()
        if wide:
            pi = np.longdouble("3.14159265358979323846264338327950288")
            want = np.cos(2 * pi * j.astype(np.longdouble) / 2 ** 24).astype(np.float64)
        else:
            q, phi = j >> 22, (j & ((1 << 22) - 1)) * ((np.pi / 2) / 2 ** 22)
            want = np.choose(q, [np.cos(phi), -np.sin(phi), -np.cos(phi), np.sin(phi)])
        assert np.abs(got - want).max() <= 4e-16


def test_normal_has_the_moments_of_a_standard_normal():
    z = d.normal(d.root_key(11), torch.arange(10 ** 6)).double()
    assert abs(z.mean().item()) < 3e-3 and abs(z.var().item() - 1) < 1e-2


@pytest.mark.parametrize("counters", ["positions", "rank_block"])
@pytest.mark.parametrize("keys", ["int", "per_client"])
def test_normal_at_by_chunks_is_the_one_draw(keys, counters, monkeypatch):
    """``normal_at`` draws ``NORMAL_CHUNK`` counters at a time (an LM
    leaf's draw at once would not fit a card): bitwise one ``normal`` draw,
    at a ragged count, at the positions themselves (the whole-tree view's
    ``flat_index``) and at a mesh rank's global flat indices (the column
    block 5..9 of a (6, 10) leaf, as ``TreeShards`` gives them)."""
    import functools

    from repro_torch.core.treeview import WHOLE

    k = d.root_key(5) if keys == "int" else d.fold_in_tensor(
        d.root_key(5), torch.arange(3))[:, None]
    if counters == "positions":
        ctr = functools.partial(WHOLE.flat_index, "w", "cpu")
        idx = torch.arange(30)
    else:
        idx = (torch.arange(6)[:, None] * 10 + 5 + torch.arange(5)[None]).reshape(-1)
        ctr = lambda lo, hi: idx[lo:hi]                              # noqa: E731
    want = d.normal(k, idx)
    assert torch.equal(d.normal_at(k, 30, ctr), want)               # one chunk
    monkeypatch.setattr(d, "NORMAL_CHUNK", 7)                       # 4 chunks + 2
    assert torch.equal(d.normal_at(k, 30, ctr), want)


@pytest.mark.parametrize("n_clients,steps,batch", [(4, 2, 8), (7, 3, 5)])
def test_one_client_gather_is_lane_c_of_the_batched_gather(n_clients, steps, batch):
    x, y, parts = SyntheticVision(n_items=160, seed=0).distribute_into_chunks(
        "dirichlet", n_clients, 0.5)
    staged = stage_partitions(x, y, parts, "cpu")
    rkey = d.round_key(d.root_key(0), 2)
    every = gather_client_batches(staged, rkey, batch, steps)
    for c in range(n_clients):
        one = gather_one_client_batch(staged, rkey, c, batch, steps)
        assert torch.equal(every["x"][c], one["x"]) and torch.equal(every["y"][c], one["y"])
        if len(parts[c]):
            rows = one["x"].reshape(-1, 32 * 32 * 3).numpy()
            part = x.reshape(len(x), -1)[parts[c]]
            assert all((part == r).all(1).any() for r in rows)


def _job(strategy, rounds_per_launch, **train):
    tp = {"n_clients": 4, "local_steps": 2, "batch_size": 4, "client_lr": 0.05,
          "rounds": 4, "rounds_per_launch": rounds_per_launch, "seed": 3}
    tp.update(train)
    job = load_job({"model": {"arch": "flsim-cnn"},
                    "dataset": {"dataset": "synthetic_vision", "n_items": 96},
                    "strategy": {"strategy": strategy, "train_params": tp},
                    "runtime": {"straggler_prob": 0.2, "straggler_overprovision": 1.5}})
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _flat(v)]
    return [tree]


@pytest.mark.parametrize("strategy,train", [
    ("scaffold", {}),
    ("gossip", {"topology": "decentralized", "gossip_steps": 2}),
    ("dp_fedavg", {"dp_clip": 0.2, "dp_noise": 0.5}),
])
def test_chunked_equals_unchunked_bitwise(strategy, train):
    runs = []
    for chunk in (3, 1):
        state, logger = Executor(_job(strategy, chunk, **train),
                                 device="cpu").scaffold().run()
        runs.append((state, logger.series("loss")))
    (s3, l3), (s1, l1) = runs
    assert l3 == l1
    a, b = _flat(s3), _flat(s1)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
