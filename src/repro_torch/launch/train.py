"""FL training launcher (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train [--job JOB.yaml] [--arch flsim-cnn]
        [--rounds 5] [--clients 8] [--reduced] [--ckpt-dir DIR] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-34b --dry-run
        [--layers K] [--device cuda]

The executor path (the paper's Alg. 1): ``load_job`` of ``--job`` or, without
one, the JAX launcher's default job (``--arch`` on 512 synthetic vision
items, fedavg over ``--clients`` clients, a checkpoint every 2 rounds) ->
``Executor(job).scaffold().run(rounds)``, on the CUDA card unless
``--device cpu`` is given; a resume from the newest checkpoint in
``--ckpt-dir``. Prints the FL dashboard. LMs train through
``repro_torch.launch.train_fl_lm`` (the executor refuses an LM job and
names it). ``--dry-run`` hands ``--arch``'s train_4k cell on the 16x16
production mesh to ``launch/dryrun.py``, as the JAX launcher hands its
lower-and-compile to its dry run: on the meta device, or on the card with
``--device cuda``; ``--layers`` cuts its stack.
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
    """Train; returns (state, logger). With ``--dry-run``: the dry run's
    records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--job", default=None, help="job yaml (paper Fig. 2)")
    ap.add_argument("--arch", default="flsim-cnn")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced config for LM archs")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--dry-run", action="store_true",
                    help="the train_4k cell of --arch as one rank of the production mesh "
                         "(delegates to launch.dryrun)")
    ap.add_argument("--layers", type=int, default=0,
                    help="--dry-run: truncate the layer stack")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu; with --dry-run, meta unless cuda is given")
    args = ap.parse_args(argv)
    if args.dry_run:
        from repro_torch.launch import dryrun
        return dryrun.main(["--arch", args.arch, "--shape", "train_4k", "--layers",
                            str(args.layers),
                            "--device", "cuda" if args.device == "cuda" else "meta"])
    job = load_job(args.job if args.job else
                   default_job(args.arch, args.clients, args.rounds, args.reduced))
    ex = Executor(job, device=args.device or "cuda", ckpt_dir=args.ckpt_dir).scaffold()
    state, logger = ex.run(args.rounds)
    print(logger.dashboard())
    return state, logger


if __name__ == "__main__":
    main()
