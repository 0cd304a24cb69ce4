"""Card-only tests of the port: the hand-written kernels against their plain
versions, and the main path through them, on a CUDA device.

Imports neither ``jax`` nor ``repro`` so it also runs on a machine with the
card and no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips with its reason. The kernel is held to its
plain version bitwise (same client order, no FMA contraction).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.jobs import load_job
from repro_torch.kernels import ops
from repro_torch.kernels import quant_aggregate as qa
from repro_torch.models.small import SmallModel
from repro_torch.runtime.executor import Executor

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(C, N, qblock, device, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randint(-127, 128, (C, N)).astype(np.int8)
    s = rng.uniform(1e-4, 1e-2, (C, N // qblock)).astype(np.float32)
    w = rng.uniform(0, 1, (C,)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (q, s, w / w.sum())]


@pytest.mark.parametrize("C,N,qblock", [(100, 189_952, 256), (16, 1 << 20, 256),
                                        (7, 4224, 128), (1, 2048, 256),
                                        (3, 16, 16)])
def test_kernel_equals_plain_bitwise(cuda, C, N, qblock):
    q, s, w = _inputs(C, N, qblock, cuda)
    launches = qa.quant_aggregate.launches
    got = qa.quant_aggregate(q, s, w)
    torch.cuda.synchronize()
    assert qa.quant_aggregate.launches == launches + 1
    assert got.shape == (N,) and torch.equal(got, qa.plain(q, s, w))


def test_kernel_rejects_misaligned_input(cuda):
    q, s, w = _inputs(2, 4096 + 16, 16, cuda)
    with pytest.raises(ValueError, match="aligned"):
        qa.quant_aggregate(q.reshape(-1)[1:1 + 2 * 4096].reshape(2, 4096),
                           s[:, :256].contiguous(), w)


def _job(compression, rounds_per_launch):
    job = load_job({
        "model": {"arch": "flsim-cnn"},
        "dataset": {"dataset": "synthetic_vision", "n_items": 256},
        "strategy": {"strategy": "compressed" if compression == "int8" else "fedavg",
                     "train_params": {"n_clients": 6, "cohort": 4, "local_steps": 2,
                                      "batch_size": 8, "client_lr": 0.05,
                                      "rounds": 4, "compression": compression,
                                      "rounds_per_launch": rounds_per_launch}},
        "runtime": {"straggler_prob": 0.1, "straggler_overprovision": 1.25}})
    job.model = SmallModel(job.model.cfg.replace(d_model=8, d_ff=16), "cnn")
    return job


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_executor_on_card_is_chunking_invariant_and_launches_per_round(
        cuda, compression):
    runs = []
    for chunk in (2, 1):
        launches = qa.quant_aggregate.launches
        with ops.quant_agg_scope() as frame:
            st, lg = Executor(_job(compression, chunk)).scaffold().run()
        assert qa.quant_aggregate.launches - launches == \
            (4 if compression == "int8" else 0)
        assert frame["calls"] == (4 if compression == "int8" else 0)
        assert st["params"]["c1"].is_cuda
        runs.append((st, lg.series("loss")))
    (s2, l2), (s1, l1) = runs
    assert l2 == l1 and all(np.isfinite(l2))
    assert all(torch.equal(s2["params"][k], s1["params"][k]) for k in s2["params"])
