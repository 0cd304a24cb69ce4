"""The hash-chain ledger (``repro_torch/core/blockchain.py``), the
control-plane store (``core/kvstore.py``) and their executor wiring, against
the JAX package and the port's own contracts, on the CPU.

- Block hashes are JSON + SHA-256: the same blocks give the same hashes in
  both packages, bit for bit.
- ``param_digest`` hashes the leaves' bytes in JAX's flatten order: the same
  params (a checkpoint written by the JAX package and restored by the port,
  and a bf16 leaf) give the same hex string in both packages.
- The executor writes one ``global`` block per chunk and publishes its
  digest as ``global_digest/<last round>``; chunks of 1 and of 3 end on the
  same digest. The async ``digest_every_events`` blocks have the JAX
  executor's count, event marks and vtimes (the schedule is the JAX
  package's, bit for bit).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.checkpoint import ckpt as j_ckpt
from repro.core import blockchain as jchain
from repro.core.jobs import load_job as j_load_job
from repro.models.small import SmallModel as JSmallModel
from repro.runtime.executor import Executor as JExecutor
from repro_torch.checkpoint import ckpt
from repro_torch.core.blockchain import HashChainLedger, get_ledger, param_digest
from repro_torch.core.consensus import poison
from repro_torch.core.jobs import load_job
from repro_torch.core.kvstore import KVStore
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


def _params():
    rng = np.random.RandomState(0)
    return {"w": torch.from_numpy(rng.randn(128).astype(np.float32)),
            "b": torch.ones(4)}


def _raw(rounds=3, rounds_per_launch=1, mode="sync", **train):
    tp = {"n_clients": 4, "local_steps": 2, "batch_size": 4, "client_lr": 0.05,
          "rounds": rounds, "rounds_per_launch": rounds_per_launch, "seed": 5,
          "mode": mode, "blockchain": "hashchain"}
    if mode == "async":
        tp.update(async_buffer=3, max_staleness=4, staleness_exponent=0.5)
    tp.update(train)
    return {"name": "ledger", "model": {"arch": "flsim-cnn"},
            "dataset": {"dataset": "synthetic_vision", "n_items": 96},
            "strategy": {"strategy": "fedavg", "train_params": tp},
            "runtime": {"straggler_prob": 0.2, "duration_sigma": 0.25,
                        "rate_spread": 0.5}}


def _job(**kw):
    job = load_job(_raw(**kw))
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


def _run(**kw):
    ex = Executor(_job(**kw), device="cpu").scaffold()
    ex.run()
    return ex


# -- the chain (tests/test_consensus_blockchain.py) ---------------------------

def test_chain_verifies_and_detects_tampering():
    led = HashChainLedger()
    p = _params()
    led.record_aggregate(0, "worker_0", p)
    led.record_consensus(0, "majority_digest", param_digest(p),
                         {"worker_0": param_digest(p)})
    led.record_global(0, p)
    assert led.verify() and len(led.blocks()) == 4
    led._chain[2].payload["chosen"] = "deadbeef"
    assert not led.verify()


def test_provenance_and_reputation():
    led = HashChainLedger()
    p = _params()
    good, bad = param_digest(p), param_digest(poison(p))
    led.record_aggregate(0, "w0", p)
    led.record_consensus(0, "majority_digest", good, {"w0": good, "w1": bad})
    led.record_global(0, p)
    assert [b.kind for b in led.provenance(good)] == ["aggregate", "consensus", "global"]
    assert led.reputation == {"w0": 1.1, "w1": 0.75}


def test_ledger_registry():
    assert get_ledger("none") is None and get_ledger(None) is None
    assert isinstance(get_ledger("hashchain"), HashChainLedger)
    with pytest.raises(KeyError, match="LedgerBackend"):
        get_ledger("ethereum-mainnet")


def test_block_hashes_equal_the_jax_package():
    """The same appends give the same chain, hash for hash."""
    ours, theirs = HashChainLedger(), jchain.HashChainLedger()
    for led in (ours, theirs):
        led.append(0, "global", {"digest": "ab" * 32})
        led.record_consensus(1, "median", "cd" * 32, {"worker_0": "cd" * 32,
                                                      "worker_1": "ef" * 32})
        led.append(1, "async_digest", {"event": 5, "vtime": 0.125, "digest": "01" * 32})
    assert [b.hash for b in ours.blocks()] == [b.hash for b in theirs.blocks()]
    assert ours.reputation == theirs.reputation and ours.verify()


# -- param_digest across packages ---------------------------------------------

def test_param_digest_of_a_checkpoint_restored_across_packages(tmp_path):
    """A JAX executor's state, written by the JAX package and restored by
    the port: the same hex string in both."""
    jjob = j_load_job(_raw(strategy="fedadam", server_lr=0.01, blockchain="none"))
    jjob.model = JSmallModel(jjob.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    jex = JExecutor(jjob).scaffold()
    jex.run(1)
    j_ckpt.save(tmp_path, 1, jex.state, extra={"next_round": 1}, async_write=False)
    ex = Executor(_job(strategy="fedadam", server_lr=0.01), device="cpu").scaffold()
    state, _ = ckpt.restore(tmp_path, 1, ex.state)
    assert param_digest(state["params"]) == jchain.param_digest(jex.state["params"])
    assert param_digest(state) == jchain.param_digest(jex.state)    # server moments too


def test_param_digest_hashes_bf16_and_nested_trees_as_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(5, 7).astype(np.float32)
    tree = {"b": {"y": torch.from_numpy(x).to(torch.bfloat16), "x": torch.arange(6)},
            "a": (torch.from_numpy(x.T.copy()), ())}
    jtree = {"b": {"y": jnp.asarray(x, jnp.bfloat16), "x": np.arange(6)},
             "a": (jnp.asarray(x.T.copy()), ())}
    assert param_digest(tree) == jchain.param_digest(jtree)
    assert param_digest({"t": torch.from_numpy(x).T}) == jchain.param_digest({"t": x.T})


# -- the control-plane store -----------------------------------------------------

def test_kvstore_publish_subscribe_keys_and_stages():
    kv = KVStore()
    seen = []
    kv.subscribe("a/1", lambda k, v: seen.append((k, v)))
    kv.publish("a/1", 3)
    kv.publish("a/2", 4)
    kv.publish("b", 5)
    assert seen == [("a/1", 3)] and kv.get("a/2") == 4 and kv.get("zz", 9) == 9
    assert sorted(kv.keys("a/")) == ["a/1", "a/2"] and len(kv.keys()) == 3
    kv.set_process_phase(2)
    for n in ("n0", "n1"):
        kv.set_node_stage(n, 4)
    assert kv.get("process_phase") == 2 and kv.all_nodes_in_stage(["n0", "n1"], 4)
    kv.set_node_stage("n1", 3)
    assert not kv.all_nodes_in_stage(["n0", "n1"], 4)


# -- the executor's ledger ----------------------------------------------------------

def test_executor_records_one_global_block_per_chunk():
    runs = {chunk: _run(rounds=3, rounds_per_launch=chunk) for chunk in (1, 3)}
    for chunk, ex in runs.items():
        blocks = [b for b in ex.job.ledger.blocks() if b.kind == "global"]
        assert [b.round for b in blocks] == ([0, 1, 2] if chunk == 1 else [2])
        assert ex.job.ledger.verify()
        for b in blocks:
            assert ex.kv.get(f"global_digest/{b.round}") == b.payload["digest"]
        assert blocks[-1].payload["digest"] == param_digest(ex.state["params"])
        assert ex.kv.all_nodes_in_stage(ex.nodes, 4) and ex.kv.get("process_phase") == 2
        assert len(ex.nodes) == 4
    assert runs[1].kv.get("global_digest/2") == runs[3].kv.get("global_digest/2")
    assert sorted(runs[3].kv.keys("global_digest/")) == ["global_digest/2"]


def test_no_ledger_writes_no_block():
    ex = _run(rounds=2, blockchain="none")
    assert ex.job.ledger is None and ex.kv.keys("global_digest/") == []


def test_async_digest_blocks_match_the_jax_executor():
    """The schedule is the JAX package's bit for bit, so the cadence emits
    the same blocks: count, event marks (multiples of 4 events) and the
    vtimes of those marks. Their digests differ (other params); chunks of 1
    and 2 give the same blocks."""
    kw = dict(rounds=4, mode="async", digest_every_events=4)
    jjob = j_load_job(_raw(rounds_per_launch=2, **kw))
    jjob.model = JSmallModel(jjob.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    jex = JExecutor(jjob).scaffold()
    jex.run()

    def digests(ledger):
        return [(b.round, b.payload["event"], b.payload["vtime"])
                for b in ledger.blocks() if b.kind == "async_digest"]
    want = digests(jjob.ledger)
    assert [e for _, e, _ in want] == [4, 8, 12]
    for chunk in (2, 1):
        ex = _run(rounds_per_launch=chunk, **kw)
        got = digests(ex.job.ledger)
        assert [(e, v) for _, e, v in got] == [(e, v) for _, e, v in want]
        assert all(v > 0 for _, _, v in got) and ex.job.ledger.verify()
        if chunk == 2:
            assert [r for r, _, _ in got] == [r for r, _, _ in want]
