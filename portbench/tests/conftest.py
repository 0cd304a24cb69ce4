"""Shared set-up of the benchmark's own tests: the import paths, a few
threads, and each cell cut to a size the CPU runs in seconds (widths and
counts cut, the same code paths)."""
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    with torch.backends.mkldnn.flags(enabled=False):
        yield
    torch.set_num_threads(n)


def _tiny(name: str):
    """(cell, config, driver) of the cell ``name``, cut for the CPU."""
    from portbench import harness
    cell, cfg, driver = harness.cell_files(name)
    if cell["driver"] == "temporal_lm":
        cfg = dict(cfg, hidden_size=64, intermediate_size=128, num_attention_heads=4,
                   num_key_value_heads=2, num_hidden_layers=2, vocab_size=512,
                   torch_dtype="float32")
        cell = dict(cell, traffic=dict(cell["traffic"], seq=32))
    else:
        t = cell["traffic"]
        cell = dict(cell, traffic=dict(
            t, trajectory_seeds=2, data=dict(t["data"], n_items=600),
            partition=dict(t["partition"], n_clients=10, min_items=5),
            train=dict(t["train"], n_clients=10, cohort=4, local_steps=2, batch_size=8,
                       rounds_per_launch=2)))
    return cell, cfg, driver


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """``tiny(name)`` -> the cell's (cell, config, driver), cut for the CPU."""
    return _tiny
