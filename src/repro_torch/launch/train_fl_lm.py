"""Federated training of an LM architecture (port of
``examples/train_fl_lm.py``).

    PYTHONPATH=src python -m repro_torch.launch.train_fl_lm --arch yi-34b --rounds 30 [--device cpu]

Temporal FL rounds (the cohort's clients trained one at a time, each
through the whole model) on a synthetic Markov token stream
(``SyntheticLM``), with a checkpoint every 10 rounds and a resume from the
newest one in ``--ckpt-dir``; on the CUDA card unless ``--device cpu`` is
given. Default is a CPU-sized model; ``--scale`` picks larger ones. Prints
the loss every 5 rounds and the FL dashboard, and fails unless the loss
fell.

``setup`` and ``run_rounds`` are the path at any size: ``chip_smoke.py``
runs them at the full width of qwen2.5-32b in bf16. As in the JAX example,
the weights, the rounds' keys and the token streams all come from seed 0.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.configs.base import FLConfig, ModelConfig, get_config
from repro_torch.configs.reduce import reduced_config
from repro_torch.core import determinism
from repro_torch.core.rounds import build_temporal_round, init_state
from repro_torch.core.strategies import get_strategy
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.metrics.logger import PerformanceLogger
from repro_torch.models import model_zoo
from repro_torch.models.transformer import FlatModel
from repro_torch.runtime.device import resolve_device

SCALES = {
    # (d_model, n_layers, d_ff, vocab) — heads stay at the reduced config's
    "tiny": (64, 2, 128, 512),
    "10m": (256, 4, 1024, 2048),
    "100m": (640, 10, 2560, 8192),
}
CKPT_EVERY = 10


def scaled_config(arch: str, scale: str) -> ModelConfig:
    """The arch's reduced config at one of ``SCALES``. The hybrid and ssm
    families keep the reduced config's layer count (one whole period), as
    the JAX example does."""
    d, L, f, v = SCALES[scale]
    cfg = reduced_config(get_config(arch)).replace(d_model=d, d_ff=f, vocab_size=v)
    return cfg if cfg.family in ("hybrid", "ssm") else cfg.replace(n_layers=L)


def setup(cfg: ModelConfig, fl: FLConfig, device, dtype=torch.float32):
    """-> (model, round_fn, state): the LM behind ``FlatModel``, the
    temporal round of ``fl``'s strategy and the initial state, drawn from
    ``root_key(0)`` in ``dtype`` on ``device``."""
    model = FlatModel(model_zoo.build(cfg))
    strategy = get_strategy(fl)
    round_fn = build_temporal_round(model, strategy, fl)
    state = init_state(model, strategy, fl, determinism.root_key(0), device=device,
                       dtype=dtype)
    return model, round_fn, state


def round_batch(lm: SyntheticLM, round_idx: int, *, clients: int, cohort: int,
                batch: int, seq: int, local_steps: int, device) -> dict:
    """The round's client data: {"tokens", "labels"}: (cohort, local_steps,
    batch, seq) int64 on ``device``, from ``SyntheticLM.client_batches`` of
    the clients the JAX example picks for the round."""
    per_client = [lm.client_batches((round_idx * 13 + i) % clients, local_steps, batch,
                                    seq, round_idx=round_idx)
                  for i in range(cohort)]
    return {k: torch.as_tensor(np.stack([b[k] for b in per_client]), dtype=torch.int64,
                               device=device) for k in per_client[0]}


def run_rounds(round_fn, state, lm: SyntheticLM, start: int, stop: int, *,
               clients: int, cohort: int, batch: int, seq: int, local_steps: int,
               device, data_round=None, ckpt_dir=None, logger=None):
    """Rounds ``start`` .. ``stop - 1``; returns (state, logger). Round r
    trains its cohort on their data of round r, or, with ``data_round``,
    every round the cohort and data of that round (fixed client data).
    Each round's ``round_s`` ends in a synchronize on the card; the loss is
    printed every 5 rounds and at the last; with ``ckpt_dir`` the state is
    saved every ``CKPT_EVERY`` rounds (synchronously)."""
    dev = torch.device(device)
    logger = logger or PerformanceLogger(run_name="fl-lm")
    root = determinism.root_key(0)
    for r in range(start, stop):
        data_r = r if data_round is None else data_round
        cbatch = round_batch(lm, data_r, clients=clients, cohort=cohort, batch=batch,
                             seq=seq, local_steps=local_steps, device=dev)
        w = torch.ones((cohort,), dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        state, m = round_fn(state, cbatch, w, determinism.round_key(root, r))
        loss = float(m["loss"])             # waits for the round's kernels
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        round_s = time.perf_counter() - t0
        logger.log_round(r, loss=loss, round_s=round_s)
        if r % 5 == 0 or r == stop - 1:
            print(f"round {r:4d} loss {loss:.4f} ({round_s:.1f}s)", flush=True)
        if ckpt_dir and (r + 1) % CKPT_EVERY == 0:
            ckpt_mod.save(ckpt_dir, r + 1, state, extra={"next_round": r + 1})
    return state, logger


def main(argv=None):
    """Train; returns (state, logger)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-34b")
    ap.add_argument("--scale", default="tiny", choices=sorted(SCALES))
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--cohort", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--local-epochs", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--strategy", default="fedavgm")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = scaled_config(args.arch, args.scale)
    n_params = model_zoo.count_params(cfg, padded=True)
    print(f"arch={cfg.name} scale={args.scale} device={dev}: "
          f"{n_params / 1e6:.1f}M params")
    fl = FLConfig(strategy=args.strategy, n_clients=args.clients,
                  local_epochs=args.local_epochs, client_lr=0.05,
                  server_momentum=0.9, seed=0)
    _, round_fn, state = setup(cfg, fl, dev)
    start_round = 0
    if args.ckpt_dir:
        last = ckpt_mod.latest_round(args.ckpt_dir)
        if last is not None:
            state, extra = ckpt_mod.restore(args.ckpt_dir, last, state)
            start_round = extra["next_round"]
            print(f"resumed from round {start_round}")

    lm = SyntheticLM(vocab=cfg.vocab_size, seed=0)
    logger = PerformanceLogger(run_name=f"fl-lm-{args.arch}-{args.scale}")
    state, logger = run_rounds(
        round_fn, state, lm, start_round, args.rounds, clients=args.clients,
        cohort=args.cohort, batch=args.batch, seq=args.seq,
        local_steps=args.local_steps, device=dev, ckpt_dir=args.ckpt_dir,
        logger=logger)
    print(logger.dashboard())
    first, last = logger.rows[0]["loss"], logger.rows[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f}")
    if not last < first:
        raise SystemExit(f"FL training must reduce loss: {first:.4f} -> {last:.4f}")
    return state, logger


if __name__ == "__main__":
    main()
