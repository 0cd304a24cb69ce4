"""Decentralized (Fedstellar-style) FL: no server, ring gossip mixing (port
of ``examples/decentralized_gossip.py``).

    PYTHONPATH=src python -m repro_torch.launch.gossip [--device cpu]

Shows per-client models diverging during local training and re-contracting
through gossip, on the CUDA card unless ``--device cpu`` is given; reports
the consensus distance ||theta_i - mean|| per round.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, get_config
from repro_torch.core import determinism
from repro_torch.core.rounds import build_spatial_round, init_state
from repro_torch.core.strategies import get_strategy
from repro_torch.data.pipeline import SyntheticVision
from repro_torch.models import model_zoo
from repro_torch.runtime.device import resolve_device


def divergence(params: dict) -> float:
    """RMS distance of the client models (leading dim) from their mean."""
    tot, n = 0.0, 0
    for k in sorted(params):
        leaf = params[k]
        tot += float(torch.sum((leaf - leaf.mean(0, keepdim=True)) ** 2))
        n += leaf[0].numel()
    return (tot / max(n, 1)) ** 0.5


def main(argv=None):
    """Run six gossip rounds; returns (losses, divergences)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    fl = FLConfig(strategy="gossip", topology="decentralized", n_clients=8,
                  local_epochs=2, client_lr=0.05, gossip_steps=1, seed=0)
    model = model_zoo.build(get_config("flsim-mlp"))
    strategy = get_strategy(fl)
    round_fn = build_spatial_round(model, strategy, fl)
    data = SyntheticVision(n_items=512, seed=0)
    x, y, parts = data.distribute_into_chunks("dirichlet", fl.n_clients, 0.5)
    root = determinism.root_key(0)
    state = init_state(model, strategy, fl, root, n_clients_local=fl.n_clients,
                       device=dev, decentralized=True)
    test = {"x": torch.as_tensor(x[:256], device=dev),
            "y": torch.as_tensor(y[:256], device=dev)}
    losses, divs = [], []
    for r in range(6):
        bs = [SyntheticVision.client_batches(x, y, parts[c], 16, 1,
                                             seed=c + 31 * r)[0]
              for c in range(fl.n_clients)]
        batch = {k: torch.as_tensor(np.stack([b[k] for b in bs]), device=dev)
                 for k in ("x", "y")}
        w = torch.ones((fl.n_clients,), dtype=torch.float32, device=dev)
        state, m = round_fn(state, batch, w, determinism.round_key(root, r))
        mean_params = {k: t.mean(0) for k, t in state["params"].items()}
        acc = float(model.accuracy(mean_params, test))
        losses.append(float(m["loss"]))
        divs.append(divergence(state["params"]))
        print(f"round {r}: loss {losses[-1]:.4f}  "
              f"mean-model acc {acc:.3f}  divergence {divs[-1]:.2e}")
    print("gossip OK")
    return losses, divs


if __name__ == "__main__":
    main()
