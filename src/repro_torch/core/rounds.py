"""FL rounds (port of ``repro/core/rounds.py``): on one device, and the
spatial round on a device mesh.

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
  accumulated in f32 in client order; on the int8 path each client's send
  is quantized straight into its row of one ``(C, N)`` matrix, reduced by
  ONE kernel launch.

With ``n_workers > 1`` or ``byzantine_workers > 0`` both rounds pass the
aggregate through ``consensus.MultiWorkerAggregator`` before the server
update (spatial: before the cast to the params' dtype), keyed by the round
key, as the JAX package does. The decentralized branch and the async event
loop run no consensus, as in the JAX package.

Scalars: the round takes the job's sweepable scalars (``client_lr``,
``server_lr``, ...) as runtime values, a ``hyper`` dict of 0-d device
tensors bound by ``bind_hyper``, as a campaign lane does; ``probes=True``
adds the read-only ``metrics["probes"]`` (``core/probes.py``).

Campaign lanes (``build_multi_round(..., lanes=True)``): the same round runs
under ``torch.func.vmap`` over a leading lane dim S of the state, the
per-lane staged ``idx``/``len`` planes, round keys, weights, scalars and
alive mask; the clients' vmap nests inside it, and the int8 aggregate of
all lanes is ONE ``ops.quant_aggregate`` launch over ``(S, C, N)`` (its
vmap rule).

The ragged client plane (``build_ragged_multi``, ``max_cohort > 0``): the
spatial round over K = max_cohort slots of a per-round cohort slab staged
by ``data/pipeline``'s slab stagers, the pads at weight 0; stateless
strategies and client-server topologies only (``check_ragged_support``).

The client gradient: a model may declare ``autograd_remat = True`` (the
LMs' ``transformer.FlatModel`` does): its loss rematerializes under plain
autograd, as the JAX package's ``jax.checkpoint`` does, so the backward
keeps each layer's input and recomputes the rest. For such a model, one
client (a one-client batch) and shared params, as the temporal round trains
its clients, ``local_train`` takes ``torch.autograd.grad`` of
``strategy.local_loss`` with no backward graph kept. Everything else (the
paper's models, the spatial round, every campaign lane) takes
``vmap(grad_and_value)`` over the client dim, which keeps every activation
(``torch.utils.checkpoint`` is refused under ``torch.func``). This module
reads the declaration and nothing else of the model. An LM never runs in a
campaign lane (``Executor.scaffold`` refuses LM jobs); if it did,
``torch.autograd.grad`` would raise under the lanes' ``vmap``.

On a mesh (``build_spatial_round(..., ctx=)``, ``sharding/axes.AxisCtx``
bound when the round is built): each rank of a ``(data, model[, pod])``
mesh holds ``C_loc`` clients, numbered from its place in the flattened
grid (``_grid_below``), trains them as above and reduces by the
topology's plan over the mesh (``topo.reduce``; in ``packed_aggregate``
only B1's (N,) numerator and the weight sum cross it); the loss and the probe moments
are summed or averaged over the grid. The temporal round on a mesh
(``build_temporal_round(..., ctx=)``, the LMs): each rank holds its
ZeRO-3 shard of every param and its shard of each client's batch; the
client's loss runs with the per-layer gather (``sharding/specs.
make_gather_fn``) and its gradient goes through ``make_grad_sync`` before
the strategy's transform, as in the JAX package's ``shard_map`` round.
Every strategy the JAX round runs runs there: int8 sends pack each rank's
own shards (one B1 launch a round a rank), top-k keeps the top of each
shard, consensus runs on the rank's shards; what is defined on the whole
model (DP's clip and noise, FedProx's term, the probes, the consensus
digest and poison) is computed on the whole model through the rank's
``sharding/specs.TreeShards``, the meshless function.
The ragged plane and campaign lanes stay meshless (a campaign shards its
lanes instead: ``runtime/campaign.py``).

Randomness: the round key ``rng`` gives every client its key
``determinism.client_key(rng, c)``, which the strategy hooks receive (DP
noise is drawn from it); the JAX package hands ``local_loss`` a per-step
key, which no strategy reads, so the port hands it the client's key.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from repro_torch.configs.base import SWEEPABLE_SCALARS, FLConfig
from repro_torch.core import determinism, packing
from repro_torch.core import probes as probelib
from repro_torch.core.consensus import build_aggregator
from repro_torch.core.strategy import Strategy, client_sgd_step, tree_add, \
    tree_sub, tree_zeros_like
from repro_torch.core.topology import Decentralized, get_topology
from repro_torch.core.treeview import WHOLE
from repro_torch.data.pipeline import DEDUP_STAGED_AXES
from repro_torch.kernels import ops
from repro_torch.runtime.device import resolve_device
from repro_torch.sharding.axes import SINGLE, AxisCtx
from repro_torch.telemetry.recorder import layer_count, layer_span, layers_on


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of same-shaped trees (dicts, tuples,
    lists, ``PackedDelta``s), keeping the structure."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, packing.PackedDelta):
        return packing.PackedDelta(*(tree_map(fn, *leaves)
                                     for leaves in zip(*trees)))
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def bind_hyper(fl: FLConfig, strategy: Strategy, hyper):
    """Rebind the sweepable scalars of ``hyper`` (0-d tensors: the single
    run's, or one lane's under the campaign's vmap) onto (fl, strategy).
    An empty or None ``hyper`` is the identity."""
    if not hyper:
        return fl, strategy
    unknown = set(hyper) - set(SWEEPABLE_SCALARS)
    if unknown:
        raise KeyError(f"non-sweepable hyper keys {sorted(unknown)}; "
                       f"sweepable scalars: {SWEEPABLE_SCALARS}")
    fl_h = dataclasses.replace(fl, **hyper)
    return fl_h, dataclasses.replace(strategy, fl=fl_h)


def pop_alive(hyper):
    """Split the lane scheduler's ``alive`` mask (a per-lane 0/1 f32, the
    one hyper entry that is no sweepable scalar) off a hyper dict. Returns
    ``(alive, rest)``; ``alive`` is None where absent (every single run)."""
    if not hyper or "alive" not in hyper:
        return None, hyper
    rest = dict(hyper)
    return rest.pop("alive"), rest


def freeze_unless(alive, new_state, old_state):
    """``new_state`` where ``alive`` > 0, else ``old_state``: a dropped or
    diverged lane holds its state. The select takes whole computed tensors,
    so for a live lane it is bitwise the identity."""
    keep = alive > 0
    return tree_map(lambda n, o: torch.where(keep, n, o), new_state, old_state)


def _zero(dev):
    return torch.zeros((), dtype=torch.float32, device=dev)


def local_train(model, strategy: Strategy, fl: FLConfig, global_params,
                server_state, client_state, batches, rng,
                pack_deltas: bool = False, per_client_params: bool = False,
                pack_out: Optional[packing.PackedDelta] = None,
                ctx: AxisCtx = SINGLE, gather_fn=None, grad_sync=None):
    """Run E local epochs over ``batches`` for every client at once.

    batches: a dict of (C, steps, B, ...) tensors, whatever its keys
    (``x``/``y`` for the paper's models, ``tokens``/``labels`` for an LM);
    client_state carries a leading client dim; rng: (C,) int64 client keys;
    ``per_client_params``: ``global_params`` carry a leading client dim too
    (decentralized models). Returns (delta, new_client_state, losses (C,)),
    the delta as (C, ...) leaves or, with ``pack_deltas``, a ``PackedDelta``
    of (C, N) int8 rows (``Strategy.postprocess_packed``), written into
    ``pack_out``'s rows where given. The gradient is
    ``vmap(grad_and_value)`` over the clients, or, for one client of a
    model that declares ``autograd_remat`` with shared params, plain
    autograd through the rematerialized loss, its leading client dim of 1
    dropped around it (see the module docstring).

    On a mesh (``ctx`` with axes; the temporal round's one client): the
    params and batches are this rank's shards, the loss runs with ``ctx``
    and ``gather_fn`` (the per-layer ZeRO-3 gather), and each gradient goes
    through ``grad_sync`` before ``strategy.grad_transform``. Only the
    autograd path runs there (collectives do not run under ``vmap``)."""
    post = (functools.partial(strategy.postprocess_packed, out=pack_out) if pack_deltas
            else strategy.postprocess)
    lead = next(iter(batches.values()))
    n_steps = lead.shape[1]
    use_mom = fl.client_optimizer == "sgdm" and fl.client_momentum > 0
    g_dim = 0 if per_client_params else None
    autograd = (getattr(model, "autograd_remat", False) and not per_client_params
                and lead.shape[0] == 1)
    loss_fn = model.loss
    if ctx.grid_axes:
        if not autograd:
            raise ValueError("local_train on a mesh trains one client of a model that "
                             "declares autograd_remat (an LM), with shared params")
        loss_fn = functools.partial(model.loss, ctx=ctx, gather_fn=gather_fn)

    def client_loss(p, g, batch, cstate, key):
        return strategy.local_loss(loss_fn, p, g, batch, cstate, key)

    grad_fn = grad_and_value(client_loss)

    def one_client_grads(params, batched: bool, batch):
        """The lone client's gradient by ``torch.autograd.grad`` (no
        backward graph kept), as (1, ...) leaves beside its (1,) loss."""
        def first(tree):
            return tree_map(lambda t: t[0], tree)
        p = {k: (v[0] if batched else v).detach().requires_grad_()
             for k, v in params.items()}
        loss = strategy.local_loss(loss_fn, p, global_params, first(batch),
                                   first(client_state), rng[0])
        grads = torch.autograd.grad(loss, list(p.values()))
        return {k: g[None] for k, g in zip(p, grads)}, loss.detach()[None]

    def step_grads(params, batched: bool, step: int):
        batch = {k: v[:, step % n_steps] for k, v in batches.items()}
        if autograd:
            grads, loss = one_client_grads(params, batched, batch)
        else:
            in_dims = (0 if batched else None, g_dim, 0, 0, 0)
            grads, loss = vmap(grad_fn, in_dims=in_dims)(
                params, global_params, batch, client_state, rng)
        if grad_sync is not None:
            grads = grad_sync(grads)
        return strategy.grad_transform(grads, client_state, server_state), loss

    def send(delta, client_state):
        if not pack_deltas:
            return post(delta, client_state, rng)
        with layer_span("send.pack", lead.device):
            return post(delta, client_state, rng)

    with layer_span("local_train", lead.device):
        if fl.local_epochs * n_steps == 1 and not use_mom:
            # one local SGD step: delta == -lr * grad, no params copy
            grads, losses = step_grads(global_params, per_client_params, 0)
            delta = {k: (grads[k] * -fl.client_lr).to(p.dtype)
                     for k, p in global_params.items()}
            delta, client_state = send(delta, client_state)
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
            del grads           # not held while the next step runs
            losses.append(loss)
        delta = tree_sub(params, global_params)
        delta, client_state = send(delta, client_state)
        client_state = strategy.client_state_update(
            client_state, server_state, delta, total, fl.client_lr)
        return delta, client_state, torch.stack(losses).mean(0)


def packed_aggregate(topo, pd: packing.PackedDelta, weights):
    """Weighted mean of stacked ``PackedDelta``s ((C, N) int8 + (C, N/b)
    scales) through the fused dequant + weighted-sum kernel: each int8 byte
    is read once, and on a mesh only the (N,) f32 numerator and the weight
    sum cross it, by the topology's plan (``topo.reduce``). Returns the
    flat (N,) f32 aggregate."""
    return topo.reduce(ops.quant_aggregate(pd.q, pd.scale, weights), weights.sum())


def _grid_below(ctx: AxisCtx, axis: str) -> int:
    """Flattened grid stride of ``axis`` for the client ids."""
    if axis == ctx.data:
        return ctx.size(ctx.model)
    if axis == ctx.pod:
        return ctx.size(ctx.model) * ctx.size(ctx.data)
    return 1


def build_spatial_round(model, strategy: Strategy, fl: FLConfig,
                        probes: bool = False, ctx: AxisCtx = SINGLE):
    """Returns round_fn(state, batch, weights, rng, hyper=None) ->
    (state, {"loss"[, "probes"]}).

    state: {"params", "server", "clients"}, with a leading client dim on
    ``params`` for the decentralized topology (one model per client);
    batch: (C, steps, B, ...); weights: (C,) f32 (partition size times the
    cohort mask); rng: the round key (an int, or a 0-d int64 tensor);
    hyper: the sweepable scalars (``bind_hyper``). ``probes`` adds the
    round's probe dict (``core/probes.py``), read off values the round
    computes anyway.

    ``ctx``: the mesh the round runs on, bound here once. With ``SINGLE``
    the round is the one-device program. With a mesh's axes this rank holds
    ``C`` of the grid's clients (ids from its place in the flattened
    ``(pod, data, model)`` grid, ``_grid_below``), each running the model
    unsharded; the aggregate, the loss and the probe moments cross the mesh
    as the JAX package's ``shard_map`` round does."""
    topo = get_topology(fl.topology, fl.gossip_steps, ctx)
    decentralized = isinstance(topo, Decentralized)
    mw = build_aggregator(fl)
    # gossip has no server-side reduce to fuse into: int8 sends take the
    # unpacked round trip there
    packed = strategy.packs_deltas and not decentralized
    axes = ctx.grid_axes
    chip = ctx.index(ctx.model)
    for axis in (ctx.data, ctx.pod):
        if axis is not None:
            chip = ctx.index(axis) * _grid_below(ctx, axis) + chip

    def psum_(x):
        return ctx.psum(x, axes)

    def pmean_(x):
        return ctx.pmean(x, axes)

    def round_fn(state, batch, weights, rng, hyper=None):
        fl_h, strategy_h = bind_hyper(fl, strategy, hyper)
        params, server_state = state["params"], state["server"]
        lead = next(iter(batch.values()))
        dev, C = lead.device, lead.shape[0]
        keys = determinism.client_keys(rng, C, dev, first=chip * C)
        deltas, cstates, losses = local_train(
            model, strategy_h, fl_h, params, server_state, state["clients"],
            batch, keys, pack_deltas=packed, per_client_params=decentralized)
        pr = {}
        if decentralized:
            new_params = topo.mix(tree_add(params, deltas))
            new_server = server_state
            if probes:
                # drift for gossip: the spread of the client models
                spread = probelib.per_client_sq_norms(
                    {k: t - pmean_(t.mean(0))[None] for k, t in new_params.items()})
                pr.update(drift_norm=torch.sqrt(pmean_(spread.mean())),
                          sat_frac=_zero(dev), ef_residual_norm=_zero(dev))
        else:
            if probes:
                # per-client moments of the sends, read before the reduce
                if packed:
                    sq = probelib.packed_sq_norms(deltas.q, deltas.scale)
                    pr["sat_frac"] = pmean_((torch.abs(deltas.q.to(torch.int32)) >= 127)
                                            .to(torch.float32).mean(-1).mean())
                else:
                    sq = probelib.per_client_sq_norms(deltas)
                    pr["sat_frac"] = _zero(dev)
                if isinstance(cstates, dict) and "residual" in cstates:
                    rsq = probelib.per_client_sq_norms(cstates["residual"])
                    if axes:
                        n_c = psum_(torch.full((), float(C), device=dev))
                        pr["ef_residual_norm"] = torch.sqrt(
                            psum_(rsq.sum()) / torch.clamp(n_c, min=1.0))
                    else:
                        pr["ef_residual_norm"] = torch.sqrt(rsq.sum() / max(C, 1))
                else:
                    pr["ef_residual_norm"] = _zero(dev)
            with layer_span("server.aggregate", dev):
                if packed:
                    agg = packing.unpack_tree(
                        packed_aggregate(topo, deltas, weights), params)
                else:
                    agg = topo.aggregate(deltas, weights)
                if mw is not None:
                    agg = mw.run(agg, rng)
                agg = {k: a.to(params[k].dtype) for k, a in agg.items()}
            with layer_span("server.update", dev):
                new_params, new_server = strategy_h.server_update(params, agg,
                                                                  server_state)
                # SCAFFOLD: the server control variate is the cohort-weighted
                # mean of the client variates
                if isinstance(new_server, dict) and "c" in new_server \
                        and isinstance(cstates, dict) and "c_i" in cstates:
                    new_server = dict(new_server,
                                      c=topo.aggregate(cstates["c_i"], weights))
            if probes:
                pr["drift_norm"] = probelib.drift_from_moments(
                    weights, sq, probelib.tree_sq_norm(agg), psum_)
        metrics = {"loss": pmean_(losses.mean())}
        if probes:
            pr["update_norm"] = probelib.tree_norm(tree_sub(new_params, params))
            pr["nonfinite"] = probelib.norm_nonfinite(pr["update_norm"])
            metrics["probes"] = pr
        return ({"params": new_params, "server": new_server,
                 "clients": cstates}, metrics)

    return round_fn


def build_temporal_round(model, strategy: Strategy, fl: FLConfig,
                         probes: bool = False, ctx: AxisCtx = SINGLE):
    """Returns round_fn(state, batch, weights, rng, hyper=None) ->
    (state, {"loss"[, "probes"]}).

    batch: (C_t, steps, B, ...): the cohort trained one client at a time
    against the round's params, with no client state (as in the JAX
    package). Deltas are accumulated in f32, in client order, each scaled
    by its normalised weight; with C_t == 1 the raw delta is applied. On the
    int8 path each send is written into its row of one preallocated (C_t,
    N) matrix, reduced by ONE ``ops.quant_aggregate`` launch with the
    normalised weights (C_t == 1: weight 1). ``probes`` as in ``build_spatial_round``
    (the drift moments accumulate client by client).

    ``ctx``: the mesh the round runs on, bound here once (``SINGLE``: one
    device). On a mesh every client uses the whole mesh: this rank holds
    the ZeRO-3 shard of every param (``state``) and its shard of each
    client's batch; ``local_train`` gathers per layer and syncs the
    gradient (``sharding/specs.make_gather_fn``, ``make_grad_sync``); the
    aggregate is averaged over ``pod`` (the cross-pod tier), then passes
    the consensus, and the loss is averaged over the whole grid, as in the
    JAX package. An int8 send packs the rank's own shards (the JAX
    package's per-rank layout: a ``(C_t, N_loc)`` matrix, one B1 launch).
    The strategy, the consensus and the probes compute through the round's
    view of the model (``core/treeview``; on a mesh the rank's
    ``specs.TreeShards``): each probe is the whole model's norm or
    fraction, the same on every rank."""
    packed = strategy.packs_deltas
    axes = ctx.grid_axes
    gather_fn = grad_sync = None
    shards = WHOLE
    if axes:
        from repro_torch.sharding import specs
        gather_fn = specs.make_gather_fn(model.cfg, ctx)
        grad_sync = specs.make_grad_sync(model.cfg, ctx)
        shards = specs.TreeShards(model.cfg, ctx)
    strategy = dataclasses.replace(strategy, shards=shards)
    mw = build_aggregator(fl, shards)

    def round_fn(state, batch, weights, rng, hyper=None):
        fl_h, strategy_h = bind_hyper(fl, strategy, hyper)
        params, server_state = state["params"], state["server"]
        lead = next(iter(batch.values()))
        C_t, dev = lead.shape[0], lead.device

        def client(i, pack_out=None):
            cbatch = {k: v[i:i + 1] for k, v in batch.items()}
            key = determinism.key_tensor(determinism.client_key(rng, i), dev)
            delta, _, loss = local_train(model, strategy_h, fl_h, params,
                                         server_state, (), cbatch, key,
                                         pack_deltas=pack_out is not None,
                                         pack_out=pack_out, ctx=ctx, gather_fn=gather_fn,
                                         grad_sync=grad_sync)
            return delta, loss[0]

        pr = {"sat_frac": _zero(dev), "ef_residual_norm": _zero(dev),
              "drift_norm": _zero(dev)} if probes else {}
        if packed:
            # each client's send quantized straight into its row of one
            # (C_t, N) int8 matrix and (C_t, N / qblock) scales, its delta
            # dropped before the next client trains
            n, n_blocks = packing.packed_size(params)
            leaf = next(iter(params.values()))     # under a campaign's vmap: its lanes
            q = leaf.new_empty((C_t, n), dtype=torch.int8)
            scale = leaf.new_empty((C_t, n_blocks), dtype=torch.float32)
            losses = [client(i, packing.PackedDelta(q[i:i + 1], scale[i:i + 1]))[1]
                      for i in range(C_t)]
            if C_t == 1:
                loss = losses[0]
                w = torch.ones((1,), dtype=torch.float32, device=dev)
            else:
                loss = torch.stack(losses).sum() / C_t
                w = weights / torch.clamp(weights.sum(), min=1e-12)
        elif C_t == 1:
            delta, loss = client(0)
            agg = {k: d[0] for k, d in delta.items()}
        else:
            agg = {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()}
            loss = 0.0
            msq = 0.0
            wsum = torch.clamp(weights.sum(), min=1e-12)
            for i in range(C_t):
                delta, closs = client(i)
                d_i = {k: d[0] for k, d in delta.items()}
                w_i = weights[i] / wsum
                # in place: one f32 accumulator, whatever the model's size;
                # each delta goes to f32 before its weight, as the JAX
                # package promotes it
                for k in d_i:
                    agg[k].add_(d_i[k].to(torch.float32) * w_i)
                loss = loss + closs / C_t
                if probes:
                    # the weighted second moment of the deltas, for drift
                    msq = msq + weights[i] / wsum * probelib.tree_sq_norm(d_i, shards)
                del delta, d_i      # not held while the next client trains
            if probes:
                pr["drift_norm"] = torch.sqrt(torch.clamp(
                    msq - probelib.tree_sq_norm(agg, shards), min=0.0))
        with layer_span("server.aggregate", dev):
            if packed:
                agg_flat = ops.quant_aggregate(q, scale, w)
                if probes:
                    pr["sat_frac"] = probelib.sat_frac(q, params, shards)
                    pr["drift_norm"] = probelib.drift_from_moments(
                        w, probelib.packed_sq_norms(q, scale, params, shards),
                        shards.sq_norm(packing.unpack_tree(agg_flat, params)))
                del q, scale
                # views of the (N,) f32 aggregate, cast one leaf at a time
                agg = {k: a.to(params[k].dtype) for k, a in
                       packing.unpack_tree(agg_flat, params).items()}
                del agg_flat
            if ctx.pod is not None:
                # the cross-pod tier: the pods' aggregates averaged
                agg = ctx.pmean(agg, ctx.pod)
            if mw is not None:
                agg = mw.run(agg, rng)
            # the f32 accumulator in the params' dtype (bf16 LM params stay
            # bf16), as the spatial round casts its mean
            agg = {k: a.to(params[k].dtype) for k, a in agg.items()}
        with layer_span("server.update", dev):
            new_params, new_server = strategy_h.server_update(params, agg,
                                                              server_state)
        metrics = {"loss": ctx.pmean(loss, axes) if axes else loss}
        if probes:
            # whole-model values on a mesh (``shards``): the same on every rank
            pr["update_norm"] = probelib.tree_norm(tree_sub(new_params, params), shards)
            pr["nonfinite"] = probelib.norm_nonfinite(pr["update_norm"])
            metrics["probes"] = pr
        return ({"params": new_params, "server": new_server,
                 "clients": state.get("clients", ())}, metrics)

    return round_fn


def build_multi_round(model, strategy: Strategy, fl: FLConfig,
                      placement: str = "spatial", fault=None,
                      batch_size: Optional[int] = None, device=None,
                      probes: bool = False, on_divergence: str = "report",
                      lanes: bool = False):
    """Run ``n_rounds`` FL rounds back to back on ``device`` (CUDA unless
    the caller passes ``device="cpu"``), with the spatial or the temporal
    round.

    Returns ``multi_fn(state, staged, root, start_round, n_rounds,
    hyper=None)`` -> ``(state, {"loss": (n_rounds,)[, "probes": (n_rounds,
    P)]})``. Per round, on the device: the batch gather from the staged
    partitions, keyed by ``determinism.round_key(root, r)``, and the
    cohort/straggler weight mask (``runtime.faults.cohort_mask``). The
    chunk's masks are drawn on the host and copied in one transfer before
    the first round, and the losses stay on the device, so nothing inside a
    chunk waits for the host. ``probes`` adds the (n_rounds, P) probe plane
    (``on_divergence="freeze"`` holds a diverged state).

    ``lanes=True``: the campaign's form, ``multi_fn(state, staged, roots,
    start_round, n_rounds, hyper, faults)``, with a leading lane dim S on
    the state, ``staged["idx"]``/``["len"]``, ``roots`` ((S,) int64) and
    every ``hyper`` entry (its ``alive`` mask too), one fault model per
    lane; every metric gains a leading S. One round of all S lanes is one
    pass of ``torch.func.vmap`` over the single round.

    Determinism contract: each round's randomness is keyed only by
    ``(seed, absolute round)``, so a run chunked as 3+3 rounds is bitwise
    the run of 6 launches of 1 round, and lane s of a campaign is bitwise
    the single run of its config.
    """
    from repro_torch.data.pipeline import gather_client_batches
    from repro_torch.runtime.faults import FaultModel, cohort_mask

    if placement == "temporal":
        single = build_temporal_round(model, strategy, fl, probes=probes)
    elif placement == "spatial":
        single = build_spatial_round(model, strategy, fl, probes=probes)
    else:
        raise ValueError(f"unknown placement {placement!r} "
                         "(want 'spatial' or 'temporal')")
    freeze_div = probes and on_divergence == "freeze"
    device = resolve_device(device)
    fault = fault if fault is not None else FaultModel(seed=fl.seed)
    batch_size = batch_size or fl.batch_size
    steps = max(fl.local_steps, 1)
    target = int(fl.cohort or fl.n_clients)

    def one_round(st, staged, rkey, eff_w, hyper, alive, n_lanes=1):
        batch = gather_client_batches(staged, rkey, batch_size, steps)
        # the client rows this round trains, in every lane (under the lanes'
        # vmap the batch's lead dim is one lane's)
        layer_count("clients_trained", next(iter(batch.values())).shape[0] * n_lanes)
        new_st, metrics = single(st, batch, eff_w, rkey, hyper)
        if probes:
            # engine probes: the cohort mask and the staged weight mass
            pr = metrics.pop("probes")
            base = staged["len"].to(torch.float32)
            pr["participation"] = (eff_w > 0).sum().to(torch.float32)
            pr["masked_frac"] = 1.0 - eff_w.sum() / torch.clamp(base.sum(), min=1e-12)
            if freeze_div:
                new_st = freeze_unless(1.0 - pr["nonfinite"], new_st, st)
        if alive is not None:
            new_st = freeze_unless(alive, new_st, st)
        if probes:
            if alive is not None:
                pr = probelib.mask_probes(alive, pr)
            metrics["probes"] = probelib.stack_probes(pr)
        return new_st, metrics

    def masks_for(faults, rounds, alive):
        """The (S, n, C) cohort masks on the device, drawn on the host. Each
        kept row of a live lane counts in ``clients_weighted`` (on the
        device: ``alive`` stays there)."""
        masks = torch.as_tensor(np.stack([
            np.stack([cohort_mask(f, r, fl.n_clients, target,
                                  fl.straggler_overprovision) for r in rounds])
            for f in faults]), device=device)
        if layers_on():
            live = masks if alive is None else masks * (alive > 0).view(-1, 1, 1)
            layer_count("clients_weighted", torch.count_nonzero(live))
        return masks

    def stacked(per_round, dim):
        return {k: torch.stack([m[k] for m in per_round], dim)
                for k in per_round[0]}

    def multi_fn(state, staged, root: int, start_round: int, n_rounds: int,
                 hyper=None):
        alive, hyper = pop_alive(hyper)
        rounds = range(start_round, start_round + n_rounds)
        masks = masks_for([fault], rounds, alive)[0]
        base_w = staged["len"].to(torch.float32)
        out = []
        for i, r in enumerate(rounds):
            state, metrics = one_round(state, staged, determinism.round_key(root, r),
                                       base_w * masks[i], hyper, alive)
            out.append(metrics)
        return state, stacked(out, 0)

    def lanes_fn(state, staged, roots, start_round: int, n_rounds: int,
                 hyper, faults):
        alive, hyper = pop_alive(hyper)
        rounds = range(start_round, start_round + n_rounds)
        masks = masks_for(faults, rounds, alive)           # (S, n, C)
        base_w = staged["len"].to(torch.float32)           # (S, C)
        S = base_w.shape[0]
        if alive is None:
            lane = vmap(lambda st, sg, rk, w, hp: one_round(st, sg, rk, w, hp, None, S),
                        in_dims=(0, DEDUP_STAGED_AXES, 0, 0, 0))
        else:
            lane = vmap(lambda st, sg, rk, w, hp, al: one_round(st, sg, rk, w, hp, al, S),
                        in_dims=(0, DEDUP_STAGED_AXES, 0, 0, 0, 0))
        out = []
        for i, r in enumerate(rounds):
            args = (state, staged, determinism.round_key(roots, r),
                    base_w * masks[:, i], hyper) + (() if alive is None else (alive,))
            state, metrics = lane(*args)
            out.append(metrics)
        return state, stacked(out, 1)

    return lanes_fn if lanes else multi_fn


def _has_client_state(strategy: Strategy) -> bool:
    """Whether the strategy carries a per-client state across rounds."""
    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (tuple, list)):
            return [x for v in t for x in leaves(v)]
        return [t]
    return bool(leaves(strategy.client_state_init({"x": torch.zeros(())})))


def check_ragged_support(fl: FLConfig, strategy: Strategy,
                         placement: str = "spatial") -> None:
    """Refuse what the ragged client plane cannot honour, with the JAX
    package's errors: it trains only the sampled cohort, so a per-client
    state (SCAFFOLD/MOON variates, error-feedback residuals) or per-client
    parameters (the decentralized topology) would silently skip the
    unsampled clients' updates; and its slab is a per-slot client grid,
    which only the spatial round reads."""
    topo = get_topology(fl.topology, fl.gossip_steps)
    if isinstance(topo, Decentralized):
        raise ValueError(
            "ragged cohorts (max_cohort > 0) need client-anonymous state, "
            "but the decentralized topology keeps per-client parameters — "
            "use a client_server/hierarchical topology or max_cohort: 0")
    if _has_client_state(strategy):
        raise ValueError(
            f"ragged cohorts (max_cohort > 0) cannot carry per-client "
            f"strategy state (strategy {fl.strategy!r}"
            + (", error_feedback" if fl.error_feedback else "")
            + ") — unsampled clients would never update it; use a "
            "stateless strategy or max_cohort: 0")
    if placement != "spatial":
        raise ValueError(
            f"ragged cohorts support the spatial placement only, got "
            f"{placement!r} — the cohort slab is a per-slot client grid")


def build_ragged_multi(model, strategy: Strategy, fl: FLConfig,
                       placement: str = "spatial",
                       batch_size: Optional[int] = None, probes: bool = False,
                       on_divergence: str = "report", lanes: bool = False):
    """The ragged-cohort form of ``build_multi_round``: each round reads one
    row of a cohort slab (``data/pipeline.SlabStager``), the sampled
    cohort's shards padded to K = max_cohort slots, instead of gathering
    every client from a resident root. Its client weights are the row's
    ``w`` (0 on pad slots), so an int8 round reduces K rows in ONE
    ``ops.quant_aggregate`` launch. The population and cohort sizes live on
    the host only.

    Returns ``multi_fn(state, slab, root, start_round, n_rounds,
    hyper=None)`` with the slab in ``build_multi_round``'s ``staged`` slot,
    or with ``lanes=True`` the campaign's ``lanes_fn(state, slab, roots,
    start_round, n_rounds, hyper, faults)``, every input with a leading
    lane dim S (the faults are drawn by the lanes' stagers, on the host);
    an int8 round of all lanes is one ``(S, K, N)`` launch. Randomness is
    keyed by (root, absolute round) and, per slot, by the slot's real client
    id, so chunking, the slab's pad width and the staging backend are
    unobservable."""
    from repro_torch.data.pipeline import gather_slab_batches

    check_ragged_support(fl, strategy, placement)
    single = build_spatial_round(model, strategy, fl, probes=probes)
    freeze_div = probes and on_divergence == "freeze"
    batch_size = batch_size or fl.batch_size
    steps = max(fl.local_steps, 1)
    k_slots = int(fl.max_cohort)

    def one_round(st, row, rkey, hyper, alive):
        batch = gather_slab_batches(row, rkey, batch_size, steps)
        eff_w = row["w"]
        new_st, metrics = single(st, batch, eff_w, rkey, hyper)
        if probes:
            # participation counts the real slots, masked_frac the slab's
            # pad share (the population's weight mass lives on the host)
            pr = metrics.pop("probes")
            real = (eff_w > 0).to(torch.float32)
            pr["participation"] = real.sum()
            pr["masked_frac"] = 1.0 - real.sum() / k_slots
            if freeze_div:
                new_st = freeze_unless(1.0 - pr["nonfinite"], new_st, st)
        if alive is not None:
            new_st = freeze_unless(alive, new_st, st)
        if probes:
            if alive is not None:
                pr = probelib.mask_probes(alive, pr)
            metrics["probes"] = probelib.stack_probes(pr)
        return new_st, metrics

    def stacked(per_round, dim):
        return {k: torch.stack([m[k] for m in per_round], dim) for k in per_round[0]}

    def multi_fn(state, slab, root: int, start_round: int, n_rounds: int,
                 hyper=None):
        alive, hyper = pop_alive(hyper)
        out = []
        for i in range(n_rounds):
            row = {k: v[i] for k, v in slab.items()}
            state, metrics = one_round(state, row, determinism.round_key(
                root, start_round + i), hyper, alive)
            out.append(metrics)
        return state, stacked(out, 0)

    def lanes_fn(state, slab, roots, start_round: int, n_rounds: int, hyper,
                 faults=None):
        alive, hyper = pop_alive(hyper)
        if alive is None:
            lane = vmap(lambda st, row, rk, hp: one_round(st, row, rk, hp, None))
        else:
            lane = vmap(one_round)
        out = []
        for i in range(n_rounds):
            row = {k: v[:, i] for k, v in slab.items()}
            args = (state, row, determinism.round_key(roots, start_round + i), hyper) \
                + (() if alive is None else (alive,))
            state, metrics = lane(*args)
            out.append(metrics)
        return state, stacked(out, 1)

    return lanes_fn if lanes else multi_fn


def _stack_clients(tree, n: int):
    """Broadcast one client's state to ``n`` clients (a real copy each)."""
    if isinstance(tree, dict):
        return {k: _stack_clients(v, n) for k, v in tree.items()}
    return tree.expand(n, *tree.shape).clone()


def init_state(model, strategy: Strategy, fl: FLConfig, key: int,
               n_clients_local: int = 1, device="cpu",
               decentralized: bool = False, dtype=torch.float32):
    """Initial FL state. Params are drawn on the CPU from
    ``generator(key)`` as ``model.init`` draws them in ``dtype`` (bf16 for
    an LM on the card), then moved, so a run starts from the same weights on
    every device. ``decentralized``: one copy of the params per client (the
    server state is then shaped like them too, as in the JAX package)."""
    params = {k: v.to(device) for k, v in
              model.init(determinism.generator(key, "cpu"), dtype).items()}
    cstate = strategy.client_state_init(params)
    if decentralized:
        params = _stack_clients(params, n_clients_local)
    return {"params": params,
            "server": strategy.server_state_init(params),
            "clients": _stack_clients(cstate, n_clients_local) if cstate else ()}
