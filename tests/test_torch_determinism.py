"""The port's randomness (``repro_torch/core/determinism.py``): fixed known
values of the hash, the per-client batch draw as a lane of the batched one,
and chunked == unchunked runs, bitwise, for the strategies whose state or
draws depend on the client and the round (SCAFFOLD's variates, gossiped
per-client models, DP noise).

The hash is splitmix64 (Steele, Lea, Flood, "Fast splittable pseudorandom
number generators", OOPSLA 2014); its first output from seed 0 is the
published 0xe220a8397b1dcdaf. Everything here is bitwise.
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
