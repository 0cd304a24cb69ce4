"""Checkpoints of the port (``repro_torch/checkpoint/ckpt.py`` and the
executor's ``ckpt_dir``/``checkpoint_every``): the JAX package's on-disk
layout, so a checkpoint of either package restores into the other bitwise,
and a run resumed from a checkpoint is bitwise the uninterrupted run (ports
of ``tests/test_driver.py:99`` and ``tests/test_async.py:205``).
"""
import numpy as np
import pytest
import torch

import jax
from repro.checkpoint import ckpt as j_ckpt
from repro.core.jobs import load_job as j_load_job
from repro.models.small import SmallModel as JSmallModel
from repro.runtime.executor import Executor as JExecutor
from repro_torch.checkpoint import ckpt
from repro_torch.core.jobs import load_job
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


def _raw(strategy="fedavg", rounds=4, rounds_per_launch=1, **train):
    tp = {"n_clients": 4, "local_steps": 2, "batch_size": 4, "client_lr": 0.05,
          "rounds": rounds, "rounds_per_launch": rounds_per_launch, "seed": 5}
    tp.update(train)
    return {"name": "ckpt", "model": {"arch": "flsim-cnn"},
            "dataset": {"dataset": "synthetic_vision", "n_items": 96},
            "strategy": {"strategy": strategy, "train_params": tp},
            "runtime": {"straggler_prob": 0.2, "duration_sigma": 0.25,
                        "rate_spread": 0.5}}


def _job(**kw):
    job = load_job(_raw(**kw))
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


def _jax_job(**kw):
    job = j_load_job(_raw(**kw))
    job.model = JSmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [np.asarray(tree.cpu() if isinstance(tree, torch.Tensor) else tree)]


STATES = {   # each with other state leaves: server moments, variates, async carries
    "fedadam": dict(strategy="fedadam", server_lr=0.01),
    "scaffold": dict(strategy="scaffold"),
    "fedbuff_int8": dict(strategy="compressed", compression="int8", mode="async",
                         async_buffer=3),
}


@pytest.mark.parametrize("case", sorted(STATES))
def test_checkpoints_restore_across_the_two_packages_bitwise(case, tmp_path):
    kw = STATES[case]
    jex = JExecutor(_jax_job(rounds=2, **kw)).scaffold()
    jstate, _ = jex.run()
    ex = Executor(_job(rounds=2, **kw), device="cpu").scaffold()
    state, _ = ex.run()
    # a JAX checkpoint into the port
    j_ckpt.save(tmp_path / "jax", 2, jstate, extra={"next_round": 2}, async_write=False)
    got, extra = ckpt.restore(tmp_path / "jax", 2, state)
    assert extra == {"next_round": 2}
    want = _leaves(jstate)
    assert len(_leaves(got)) == len(want) > 10
    for g, w in zip(_leaves(got), want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # a port checkpoint into JAX
    ckpt.save(tmp_path / "port", 2, state, extra={"next_round": 2})
    back, _ = j_ckpt.restore(tmp_path / "port", 2, jstate)
    for b, s in zip(_leaves(jax.tree.map(np.asarray, back)), _leaves(state)):
        assert b.dtype == s.dtype and np.array_equal(b, s)


def test_save_keeps_the_newest_rounds_and_refuses_a_mismatched_state(tmp_path):
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3)}, "server": (), "clients": ()}
    for r in range(5):
        assert ckpt.save(tmp_path, r, state) == tmp_path / f"round_{r:08d}"
    assert sorted(p.name for p in tmp_path.glob("round_*")) == \
        [f"round_{r:08d}" for r in range(5 - ckpt.KEEP_LAST, 5)]
    assert ckpt.latest_round(tmp_path) == 4
    with pytest.raises(ValueError, match="leaf /params/w"):
        ckpt.restore(tmp_path, 4, {"params": {"w": torch.zeros(3, 2)}})


@pytest.mark.parametrize("kw", [
    dict(strategy="compressed", compression="int8", rounds_per_launch=3),
    dict(strategy="compressed", compression="int8", mode="async", async_buffer=2,
         rounds_per_launch=2),
], ids=["sync_int8", "fedbuff_int8"])
def test_resume_equals_uninterrupted_bitwise(kw, tmp_path):
    """checkpoint_every 2 with chunks that do not divide it: a save lands
    whenever a chunk crosses a multiple, and a new executor resumes there."""
    ref, ref_log = Executor(_job(rounds=6, **kw), device="cpu").scaffold().run()
    ex = Executor(_job(rounds=6, checkpoint_every=2, **kw), device="cpu",
                  ckpt_dir=str(tmp_path)).scaffold()
    ex.run(rounds=3)
    last = ckpt.latest_round(tmp_path)
    assert last in (2, 3)
    ex2 = Executor(_job(rounds=6, checkpoint_every=2, **kw), device="cpu",
                   ckpt_dir=str(tmp_path)).scaffold()
    assert ex2.round_idx == last
    state, log = ex2.run()
    assert log.series("loss") == ref_log.series("loss")[last:]
    assert len(_leaves(state)) == len(_leaves(ref))
    assert all(np.array_equal(a, b) for a, b in zip(_leaves(state), _leaves(ref)))
