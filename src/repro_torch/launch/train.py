"""FL training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train [--job JOB.yaml] [--arch flsim-cnn]
        [--rounds 5] [--clients 8] [--reduced] [--ckpt-dir DIR] [--device cpu]

The executor path (the paper's Alg. 1): ``load_job`` of ``--job`` or, without
one, the JAX launcher's default job (``--arch`` on 512 synthetic vision
items, fedavg over ``--clients`` clients, a checkpoint every 2 rounds) ->
``Executor(job).scaffold().run(rounds)``, on the CUDA card unless
``--device cpu`` is given; a resume from the newest checkpoint in
``--ckpt-dir``. Prints the FL dashboard. LMs train through
``repro_torch.launch.train_fl_lm`` (the executor refuses an LM job and
names it). ``--dry-run`` (the JAX package's lower-and-compile of the LM
step on a production mesh) waits for the meta-device dry run, ROADMAP
A16.4.
"""
from __future__ import annotations

import argparse

from repro_torch.core.jobs import load_job
from repro_torch.runtime.executor import Executor


def default_job(arch: str, clients: int, rounds: int, reduced: bool = False) -> dict:
    """The job the JAX launcher runs without ``--job``."""
    return {
        "name": f"train-{arch}",
        "model": {"arch": arch, "reduced": reduced},
        "dataset": {"dataset": "synthetic_vision", "n_items": 512},
        "strategy": {"strategy": "fedavg",
                     "train_params": {"n_clients": clients, "client_lr": 0.05,
                                      "local_epochs": 1, "rounds": rounds,
                                      "checkpoint_every": 2}},
    }


def main(argv=None):
    """Train; returns (state, logger)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--job", default=None, help="job yaml (paper Fig. 2)")
    ap.add_argument("--arch", default="flsim-cnn")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config for LM archs")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--dry-run", action="store_true",
                    help="lower + compile the LM step on a mesh (ROADMAP A16.4)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.dry_run:
        raise ValueError("--dry-run (the LM step's lower-and-compile on a device mesh) "
                         "comes with the meta-device dry run of the multi-device port, "
                         "ROADMAP A16.4")
    job = load_job(args.job if args.job else
                   default_job(args.arch, args.clients, args.rounds, args.reduced))
    ex = Executor(job, device=args.device, ckpt_dir=args.ckpt_dir).scaffold()
    state, logger = ex.run(args.rounds)
    print(logger.dashboard())
    return state, logger


if __name__ == "__main__":
    main()
