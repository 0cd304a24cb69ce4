"""``repro_torch.launch.train`` (port of ``repro/launch/train.py``, ROADMAP
A15.7) on the CPU: the JAX launcher's default job through the executor
path, bitwise the port's ``Executor`` run of the same job dict; a ``--job``
file and a ``--ckpt-dir`` resume; an LM ``--arch`` refused by the executor,
naming ``train_fl_lm``. ``--dry-run`` is held in ``tests/test_torch_dryrun.py``.

The default job runs its default 5 rounds: at 2 its loss rises, in the port
(2.44 -> 3.51 on the CPU) as in the JAX launcher, whose 5 rounds on the CPU
peak at 3.13 and end at 2.27.
"""
import pytest
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.core.jobs import load_job
from repro_torch.launch import train
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


def test_the_default_job_trains_bitwise_the_executor_run_and_the_loss_falls(capsys):
    state, logger = train.main(["--device", "cpu"])
    assert "FL dashboard: train-flsim-cnn (5 rounds)" in capsys.readouterr().out
    losses = logger.series("loss")
    assert len(losses) == 5 and losses[-1] < losses[0], losses
    job = load_job(train.default_job("flsim-cnn", clients=8, rounds=5))
    want_state, want_logger = Executor(job, device="cpu").scaffold().run(5)
    assert want_logger.series("loss") == losses
    for k, v in want_state["params"].items():
        assert torch.equal(state["params"][k], v), k


def test_a_job_file_resumes_from_its_checkpoint(tmp_path):
    job = tmp_path / "job.yaml"
    job.write_text("name: logreg\n"
                   "model: {arch: flsim-logreg}\n"
                   "dataset: {dataset: synthetic_vision, n_items: 256}\n"
                   "strategy:\n  strategy: fedavg\n"
                   "  train_params: {n_clients: 4, rounds: 4, client_lr: 0.05,\n"
                   "                 checkpoint_every: 2}\n")
    argv = ["--device", "cpu", "--job", str(job)]
    whole, log_a = train.main(argv + ["--rounds", "4"])
    ckpt_dir = tmp_path / "ckpt"
    train.main(argv + ["--rounds", "2", "--ckpt-dir", str(ckpt_dir)])
    assert ckpt.latest_round(ckpt_dir) == 2
    resumed, log_b = train.main(argv + ["--rounds", "4", "--ckpt-dir", str(ckpt_dir)])
    assert log_b.series("loss") == log_a.series("loss")[2:]
    for k, v in whole["params"].items():
        assert torch.equal(resumed["params"][k], v), k


@pytest.mark.parametrize("argv", [["--arch", "yi-34b"], ["--arch", "minicpm3-4b", "--reduced"]])
def test_an_lm_arch_is_sent_to_train_fl_lm(argv):
    with pytest.raises(ValueError, match="repro_torch.launch.train_fl_lm"):
        train.main(argv + ["--device", "cpu", "--rounds", "2"])
