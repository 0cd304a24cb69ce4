"""Quickstart: the paper's core loop through the port's public API (port of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

Defines an FL job (the paper's Fig. 2 sections as a dict), scaffolds it
through ``load_job``, runs FedAvg over Dirichlet-partitioned clients with
the executor, on the CUDA card unless ``--device cpu`` is given, prints the
FL dashboard, and checks that the loss fell.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.jobs import load_job
from repro_torch.runtime.executor import Executor

JOB = {
    "name": "quickstart",
    "model": {"arch": "flsim-cnn"},
    "dataset": {
        "dataset": "synthetic_vision",
        "n_items": 512,
        "distribution": {"partition": "dirichlet", "dirichlet_alpha": 0.5},
    },
    "strategy": {
        "strategy": "fedavg",
        # rounds_per_launch=5 runs all 5 rounds back to back on the device;
        # batches and cohorts are drawn there, the host only sees the chunk
        # boundary. placement can be "temporal" to train one client at a time.
        "train_params": {"n_clients": 8, "local_epochs": 2,
                         "client_lr": 0.05, "rounds": 5, "seed": 0,
                         "rounds_per_launch": 5, "placement": "spatial"},
    },
    "runtime": {"straggler_prob": 0.1, "straggler_overprovision": 1.25},
}


def main(argv=None):
    """Run the quickstart job; returns its logger."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    job = load_job(JOB)
    # the CNN at half its config width, as the JAX example runs it
    job.model = job.model.__class__(job.model.cfg.replace(d_model=32, d_ff=64),
                                    job.model.kind)
    ex = Executor(job, device=args.device).scaffold()

    def eval_fn(params):
        x, y, _ = ex.data
        dev = params["c1"].device
        return {"accuracy": job.model.accuracy(
            params, {"x": torch.as_tensor(x[:256], device=dev),
                     "y": torch.as_tensor(y[:256], device=dev)})}

    ex.eval_fn = eval_fn
    _, logger = ex.run()
    print(logger.dashboard())
    if not logger.rows[-1]["loss"] < logger.rows[0]["loss"]:
        raise SystemExit(f"quickstart: the loss did not fall: {logger.series('loss')}")
    print("quickstart OK")
    return logger


if __name__ == "__main__":
    main()
