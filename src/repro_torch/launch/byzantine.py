"""Multi-worker aggregation with a byzantine worker + blockchain audit trail
(port of ``examples/byzantine_consensus.py``).

    PYTHONPATH=src python -m repro_torch.launch.byzantine [--device cpu]

Replicates the paper's RQ3/RQ4 story end to end, on the CUDA card unless
``--device cpu`` is given: three redundant workers (one malicious),
majority-digest consensus (the "smart contract"), and a hash-chain ledger
recording aggregate digests, consensus decisions, worker reputations and
global-model provenance.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, get_config
from repro_torch.core import determinism
from repro_torch.core.blockchain import HashChainLedger, param_digest
from repro_torch.core.consensus import poison
from repro_torch.core.rounds import build_spatial_round, init_state
from repro_torch.core.strategies import get_strategy
from repro_torch.data.pipeline import SyntheticVision
from repro_torch.models import model_zoo
from repro_torch.runtime.device import resolve_device


def main(argv=None):
    """Run four consensus rounds; returns (losses, ledger)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    fl = FLConfig(strategy="fedavg", n_clients=6, local_epochs=1,
                  client_lr=0.1, n_workers=3, byzantine_workers=1,
                  consensus="majority_digest", blockchain="hashchain",
                  seed=0)
    model = model_zoo.build(get_config("flsim-mlp"))
    strategy = get_strategy(fl)
    ledger = HashChainLedger()
    round_fn = build_spatial_round(model, strategy, fl)
    data = SyntheticVision(n_items=384, seed=0)
    x, y, parts = data.distribute_into_chunks("dirichlet", fl.n_clients, 0.5)
    root = determinism.root_key(0)
    state = init_state(model, strategy, fl, root, n_clients_local=fl.n_clients,
                       device=dev)
    losses = []
    for r in range(4):
        bs = [SyntheticVision.client_batches(x, y, parts[c], 16, 1,
                                             seed=c + 101 * r)[0]
              for c in range(fl.n_clients)]
        batch = {k: torch.as_tensor(np.stack([b[k] for b in bs]), device=dev)
                 for k in ("x", "y")}
        w = torch.ones((fl.n_clients,), dtype=torch.float32, device=dev)
        state, m = round_fn(state, batch, w, determinism.round_key(root, r))
        # ledger: record each worker's (possibly poisoned) digest + decision
        good = param_digest(state["params"])
        digests = {}
        for wk in range(fl.n_workers):
            if wk < fl.byzantine_workers:
                digests[f"worker_{wk}"] = param_digest(
                    poison(state["params"], 3.0))
            else:
                digests[f"worker_{wk}"] = good
            ledger.record_aggregate(r, f"worker_{wk}", state["params"])
        ledger.record_consensus(r, "majority_digest", good, digests)
        ledger.record_global(r, state["params"])
        losses.append(float(m["loss"]))
        print(f"round {r}: loss {losses[-1]:.4f} global digest {good[:12]}…")
    if not ledger.verify():
        raise SystemExit("byzantine: the chain does not verify")
    print("\nworker reputations:", {k: round(v, 2)
                                    for k, v in ledger.reputation.items()})
    prov = ledger.provenance(param_digest(state["params"]))
    print(f"provenance of final model: {len(prov)} block(s); "
          f"chain length {len(ledger.blocks())}; verified=True")
    return losses, ledger


if __name__ == "__main__":
    main()
