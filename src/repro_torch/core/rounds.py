"""FL rounds on one device (port of the meshless subset of
``repro/core/rounds.py``).

Two client placements:

- ``spatial``: every client trains in the same step. The per-client gradient
  is ``torch.func.vmap(grad_and_value(loss))`` over a leading client dim,
  and everything around it (SGD, deltas, quantization, aggregation) is
  written out over that dim. With ``compression: int8`` each client's delta
  leaves as a ``packing.PackedDelta`` row and the server reduces the
  ``(C, N)`` int8 matrix through ``kernels/ops.quant_aggregate``: one kernel
  launch per round. The decentralized topology keeps one model per client
  and gossips them instead of aggregating.
- ``temporal``: the clients train one at a time and their deltas are
  accumulated in f32 in client order; on the int8 path the clients' sends
  are stacked into one ``(C, N)`` matrix and reduced by ONE kernel launch.

With ``n_workers > 1`` or ``byzantine_workers > 0`` both rounds pass the
aggregate through ``consensus.MultiWorkerAggregator`` before the server
update (spatial: before the cast to the params' dtype), keyed by the round
key, as the JAX package does. The decentralized branch and the async event
loop run no consensus, as in the JAX package.

Randomness: the round key ``rng`` gives every client its key
``determinism.client_key(rng, c)``, which the strategy hooks receive (DP
noise is drawn from it); the JAX package hands ``local_loss`` a per-step
key, which no strategy reads, so the port hands it the client's key.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs.base import FLConfig
from repro_torch.core import determinism, packing
from repro_torch.core.consensus import build_aggregator
from repro_torch.core.strategy import Strategy, client_sgd_step, tree_add, \
    tree_scale, tree_sub, tree_zeros_like
from repro_torch.core.topology import Decentralized, get_topology
from repro_torch.kernels import ops
from repro_torch.runtime.device import resolve_device


def local_train(model, strategy: Strategy, fl: FLConfig, global_params,
                server_state, client_state, batches, rng,
                pack_deltas: bool = False, per_client_params: bool = False):
    """Run E local epochs over ``batches`` for every client at once.

    batches: {"x": (C, steps, B, ...), "y": (C, steps, B)}; client_state
    carries a leading client dim; rng: (C,) int64 client keys;
    ``per_client_params``: ``global_params`` carry a leading client dim too
    (decentralized models). Returns (delta, new_client_state, losses (C,)),
    the delta as (C, ...) leaves or, with ``pack_deltas``, a ``PackedDelta``
    of (C, N) int8 rows (``Strategy.postprocess_packed``)."""
    post = strategy.postprocess_packed if pack_deltas else strategy.postprocess
    n_steps = batches["x"].shape[1]
    use_mom = fl.client_optimizer == "sgdm" and fl.client_momentum > 0
    g_dim = 0 if per_client_params else None

    def client_loss(p, g, batch, cstate, key):
        return strategy.local_loss(model.loss, p, g, batch, cstate, key)

    grad_fn = grad_and_value(client_loss)

    def step_grads(params, batched: bool, step: int):
        batch = {k: v[:, step % n_steps] for k, v in batches.items()}
        in_dims = (0 if batched else None, g_dim, 0, 0, 0)
        grads, loss = vmap(grad_fn, in_dims=in_dims)(
            params, global_params, batch, client_state, rng)
        return strategy.grad_transform(grads, client_state, server_state), loss

    if fl.local_epochs * n_steps == 1 and not use_mom:
        # one local SGD step: delta == -lr * grad, no params copy
        grads, losses = step_grads(global_params, per_client_params, 0)
        delta = {k: (grads[k] * -fl.client_lr).to(p.dtype)
                 for k, p in global_params.items()}
        delta, client_state = post(delta, client_state, rng)
        client_state = strategy.client_state_update(
            client_state, server_state, delta, 1, fl.client_lr)
        return delta, client_state, losses

    total = fl.local_epochs * n_steps
    params = global_params
    mom = tree_zeros_like(global_params) if use_mom else None
    losses = []
    for i in range(total):
        grads, loss = step_grads(params, i > 0 or per_client_params, i)
        params, mom = client_sgd_step(params, grads, fl.client_lr, mom,
                                      fl.client_momentum)
        losses.append(loss)
    delta = tree_sub(params, global_params)
    delta, client_state = post(delta, client_state, rng)
    client_state = strategy.client_state_update(
        client_state, server_state, delta, total, fl.client_lr)
    return delta, client_state, torch.stack(losses).mean(0)


def packed_aggregate(topo, pd: packing.PackedDelta, weights):
    """Weighted mean of stacked ``PackedDelta``s ((C, N) int8 + (C, N/b)
    scales) through the fused dequant + weighted-sum kernel: each int8 byte
    is read once. On one device both client-server and hierarchical reduce
    to this one mean. Returns the flat (N,) f32 aggregate."""
    num = ops.quant_aggregate(pd.q, pd.scale, weights)
    return num / torch.clamp(weights.sum(), min=1e-12)


def build_spatial_round(model, strategy: Strategy, fl: FLConfig):
    """Returns round_fn(state, batch, weights, rng) -> (state, {"loss"}).

    state: {"params", "server", "clients"}, with a leading client dim on
    ``params`` for the decentralized topology (one model per client);
    batch: (C, steps, B, ...); weights: (C,) f32 (partition size times the
    cohort mask); rng: the round key."""
    topo = get_topology(fl.topology, fl.gossip_steps)
    decentralized = isinstance(topo, Decentralized)
    mw = build_aggregator(fl)
    # gossip has no server-side reduce to fuse into: int8 sends take the
    # unpacked round trip there
    packed = strategy.packs_deltas and not decentralized

    def round_fn(state, batch, weights, rng):
        params, server_state = state["params"], state["server"]
        keys = determinism.client_keys(rng, batch["x"].shape[0],
                                       batch["x"].device)
        deltas, cstates, losses = local_train(
            model, strategy, fl, params, server_state, state["clients"],
            batch, keys, pack_deltas=packed, per_client_params=decentralized)
        if decentralized:
            new_params = topo.mix(tree_add(params, deltas))
            new_server = server_state
        else:
            if packed:
                agg = packing.unpack_tree(
                    packed_aggregate(topo, deltas, weights), params)
            else:
                agg = topo.aggregate(deltas, weights)
            if mw is not None:
                agg = mw.run(agg, rng)
            agg = {k: a.to(params[k].dtype) for k, a in agg.items()}
            new_params, new_server = strategy.server_update(params, agg,
                                                            server_state)
            # SCAFFOLD: the server control variate is the cohort-weighted
            # mean of the client variates
            if isinstance(new_server, dict) and "c" in new_server \
                    and isinstance(cstates, dict) and "c_i" in cstates:
                new_server = dict(new_server,
                                  c=topo.aggregate(cstates["c_i"], weights))
        return ({"params": new_params, "server": new_server,
                 "clients": cstates}, {"loss": losses.mean()})

    return round_fn


def build_temporal_round(model, strategy: Strategy, fl: FLConfig):
    """Returns round_fn(state, batch, weights, rng) -> (state, {"loss"}).

    batch: (C_t, steps, B, ...): the cohort trained one client at a time
    against the round's params, with no client state (as in the JAX
    package). Deltas are accumulated in f32, in client order, each scaled
    by its normalised weight; with C_t == 1 the raw delta is applied. On the
    int8 path the C_t sends are stacked into one (C_t, N) matrix and
    reduced by ONE ``ops.quant_aggregate`` launch with the normalised
    weights (C_t == 1: weight 1)."""
    packed = strategy.packs_deltas
    mw = build_aggregator(fl)

    def round_fn(state, batch, weights, rng):
        params, server_state = state["params"], state["server"]
        C_t = batch["x"].shape[0]
        dev = batch["x"].device

        def client(i, pack: bool):
            cbatch = {k: v[i:i + 1] for k, v in batch.items()}
            key = determinism.key_tensor(determinism.client_key(rng, i), dev)
            delta, _, loss = local_train(model, strategy, fl, params,
                                         server_state, (), cbatch, key,
                                         pack_deltas=pack)
            return delta, loss[0]

        if packed:
            sends = [client(i, True) for i in range(C_t)]
            q = torch.cat([pd.q for pd, _ in sends])
            scale = torch.cat([pd.scale for pd, _ in sends])
            if C_t == 1:
                loss = sends[0][1]
                w = torch.ones((1,), dtype=torch.float32, device=dev)
            else:
                loss = torch.stack([l for _, l in sends]).sum() / C_t
                w = weights / torch.clamp(weights.sum(), min=1e-12)
            agg_flat = ops.quant_aggregate(q, scale, w)
            agg = {k: a.to(params[k].dtype) for k, a in
                   packing.unpack_tree(agg_flat, params).items()}
        elif C_t == 1:
            delta, loss = client(0, False)
            agg = {k: d[0] for k, d in delta.items()}
        else:
            agg = {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()}
            loss = 0.0
            wsum = torch.clamp(weights.sum(), min=1e-12)
            for i in range(C_t):
                delta, closs = client(i, False)
                agg = tree_add(agg, tree_scale({k: d[0] for k, d in delta.items()},
                                               weights[i] / wsum))
                loss = loss + closs / C_t
        if mw is not None:
            agg = mw.run(agg, rng)
        new_params, new_server = strategy.server_update(params, agg,
                                                        server_state)
        return ({"params": new_params, "server": new_server,
                 "clients": state.get("clients", ())}, {"loss": loss})

    return round_fn


def build_multi_round(model, strategy: Strategy, fl: FLConfig,
                      placement: str = "spatial", fault=None,
                      batch_size: Optional[int] = None, device=None):
    """Run ``n_rounds`` FL rounds back to back on ``device`` (CUDA unless
    the caller passes ``device="cpu"``), with the spatial or the temporal
    round.

    Returns ``multi_fn(state, staged, root, start_round, n_rounds)`` ->
    ``(state, {"loss": (n_rounds,) tensor})``. Per round, on the device:
    the batch gather from the staged partitions, keyed by
    ``determinism.round_key(root, r)``, and the cohort/straggler weight mask
    (``runtime.faults.cohort_mask``). The chunk's masks are drawn on the
    host and copied in one transfer before the first round, and the losses
    stay on the device, so nothing inside a chunk waits for the host.

    Determinism contract: each round's randomness is keyed only by
    ``(seed, absolute round)``, so a run chunked as 3+3 rounds is bitwise
    the run of 6 launches of 1 round.
    """
    from repro_torch.data.pipeline import gather_client_batches
    from repro_torch.runtime.faults import FaultModel, cohort_mask

    if placement == "temporal":
        single = build_temporal_round(model, strategy, fl)
    elif placement == "spatial":
        single = build_spatial_round(model, strategy, fl)
    else:
        raise ValueError(f"unknown placement {placement!r} "
                         "(want 'spatial' or 'temporal')")
    device = resolve_device(device)
    fault = fault if fault is not None else FaultModel(seed=fl.seed)
    batch_size = batch_size or fl.batch_size
    steps = max(fl.local_steps, 1)
    target = int(fl.cohort or fl.n_clients)

    def multi_fn(state, staged, root: int, start_round: int, n_rounds: int):
        rounds = range(start_round, start_round + n_rounds)
        masks = torch.as_tensor(np.stack(
            [cohort_mask(fault, r, fl.n_clients, target,
                         fl.straggler_overprovision) for r in rounds]),
            device=device)
        base_w = staged["len"].to(torch.float32)
        losses = []
        for i, r in enumerate(rounds):
            rkey = determinism.round_key(root, r)
            batch = gather_client_batches(staged, rkey, batch_size, steps)
            state, metrics = single(state, batch, base_w * masks[i], rkey)
            losses.append(metrics["loss"])
        return state, {"loss": torch.stack(losses)}

    return multi_fn


def _stack_clients(tree, n: int):
    """Broadcast one client's state to ``n`` clients (a real copy each)."""
    if isinstance(tree, dict):
        return {k: _stack_clients(v, n) for k, v in tree.items()}
    return tree.expand(n, *tree.shape).clone()


def init_state(model, strategy: Strategy, fl: FLConfig, key: int,
               n_clients_local: int = 1, device="cpu",
               decentralized: bool = False):
    """Initial FL state. Params are drawn on the CPU from
    ``generator(key)`` and then moved, so a run starts from the same weights
    on every device. ``decentralized``: one copy of the params per client
    (the server state is then shaped like them too, as in the JAX
    package)."""
    params = {k: v.to(device) for k, v in
              model.init(determinism.generator(key, "cpu")).items()}
    cstate = strategy.client_state_init(params)
    if decentralized:
        params = _stack_clients(params, n_clients_local)
    return {"params": params,
            "server": strategy.server_state_init(params),
            "clients": _stack_clients(cstate, n_clients_local) if cstate else ()}
