"""Event-driven asynchronous FL servers, FedAsync and FedBuff (port of
``repro/core/async_rounds.py``).

The loop runs over *server events*, one completed client task each, in the
order of the virtual clock (``runtime/clock.build_schedule``). The schedule
is numpy on the host, so every branch (apply or not, accepted or not, which
ring slot) is a host ``if`` and no event waits for the device. Per event:

1. the arriving client's batch is gathered from the partitions staged on the
   device (``data/pipeline.gather_one_client_batch``: bitwise lane ``c`` of
   the sync round's gather, keyed by (root, task index, client)), or on
   the ragged client plane from the event's row of the launch's event slab
   with the same draw (``gather_event_batch``);
2. the client trains against the **stale snapshot** it was dispatched with,
   a ring of the last ``max_staleness + 1`` server versions indexed by the
   schedule's ring slot;
3. the staleness-weighted update is folded into the accumulator and, where
   the schedule says so, applied through ``Strategy.server_update``, and the
   new version is written into the ring.

Two servers, selected by ``FLConfig.async_buffer``:

- **FedAsync** (buffer <= 1): every accepted arrival applies at once, in the
  mixing form ``alpha_s * (client_model - server_params)`` with
  ``alpha_s = (1 + staleness)^-staleness_exponent`` (Xie et al.);
- **FedBuff** (buffer K > 1): the staleness-and-size weighted mean of K
  client deltas, then one server update (Nguyen et al.). With buffer ==
  cohort, no staleness discount and equal client speeds this is bitwise
  synchronous temporal FedAvg.

On the int8 path FedBuff carries its open group quantized, ``qbuf (K, N)``
int8 + ``sbuf`` scales + ``cbuf`` coefficients, and a flush is ONE
``ops.quant_aggregate`` launch over the K rows; packed FedAsync scales its
event's send by one launch with C = 1.

Determinism contract: every event's randomness is keyed by (root, client,
absolute task index) and the schedule is a function of the seed, so a run
chunked into launches of any number of events is bitwise the unchunked run.

``probes=True`` adds a per-event probe plane (``core/probes.py``), which
the executor reduces to rounds; ``on_divergence="freeze"`` holds the state
at an event whose update is not finite. ``build_async_lanes`` runs a
campaign's S lanes together, each with its own schedule, ring and buffer:
every event trains all lanes in one vmapped pass, and at an event where
some lane applies, all lanes compute the flush (ONE ``(S, K, N)`` B1 launch
on the int8 FedBuff path) and each keeps it only if its schedule applies.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from repro_torch.configs.base import FLConfig
from repro_torch.core import determinism, packing
from repro_torch.core import probes as probelib
from repro_torch.core.rounds import bind_hyper, freeze_unless, \
    local_train, pop_alive
from repro_torch.core.strategy import Strategy, tree_add, tree_sub, \
    tree_zeros_like
from repro_torch.data.pipeline import (DEDUP_STAGED_AXES, gather_event_batch,
                                       gather_one_client_batch)
from repro_torch.kernels import ops


def _packed_fedbuff(fl: FLConfig, strategy: Strategy) -> bool:
    return strategy.packs_deltas and max(fl.async_buffer, 1) > 1


def async_init_state(state: dict, ring: int, fl: FLConfig = None,
                     strategy: Strategy = None) -> dict:
    """Augment a sync ``init_state`` with the async carries.

    ``hist`` is the param-version ring (every slot starts at version 0, so
    staleness-0 reads are exact); ``acc`` the open accumulator, carried
    across launches so chunking can split a buffer group. On the packed
    FedBuff path the open group is carried quantized: ``qbuf``/``sbuf`` the
    K pending sends in the kernel's (K, N) int8 + (K, N/b) layout, ``cbuf``
    their coefficients, ``bufn`` the count of accepted arrivals in it."""
    params = state["params"]
    hist = {k: t.unsqueeze(0).repeat(ring, *([1] * t.dim()))
            for k, t in params.items()}
    acc = {k: torch.zeros_like(t, dtype=torch.float32) for k, t in params.items()}
    out = dict(state, hist=hist, acc=acc)
    if fl is not None and strategy is not None and _packed_fedbuff(fl, strategy):
        n, nblocks = packing.packed_size(params)
        k = fl.async_buffer
        dev = next(iter(params.values())).device
        out["qbuf"] = torch.zeros((k, n), dtype=torch.int8, device=dev)
        out["sbuf"] = torch.zeros((k, nblocks), dtype=torch.float32, device=dev)
        out["cbuf"] = torch.zeros((k,), dtype=torch.float32, device=dev)
        out["bufn"] = torch.zeros((), dtype=torch.int32, device=dev)
    return out


def _open_group(sched, event: int) -> int:
    """Accepted arrivals between the last apply before ``event`` and it:
    the open FedBuff group's size (``bufn``), from the schedule alone."""
    n = 0
    for e in range(event - 1, -1, -1):
        if sched.apply[e]:
            break
        n += int(sched.accept[e])
    return n


def _event_probes(new_params, params, stale, accept, delta, packed: bool, dev):
    """The probes of one event (``core/probes.py``, the async forms)."""
    upd = probelib.tree_norm(tree_sub(new_params, params))
    return {"update_norm": upd,
            "drift_norm": probelib.tree_norm(tree_sub(stale, params)),
            "participation": accept, "masked_frac": 1.0 - accept,
            "sat_frac": (probelib.sat_frac(delta.q) if packed
                         else torch.zeros((), dtype=torch.float32, device=dev)),
            "ef_residual_norm": torch.zeros((), dtype=torch.float32, device=dev),
            "nonfinite": probelib.norm_nonfinite(upd)}


def build_async_multi(model, strategy: Strategy, fl: FLConfig,
                      batch_size=None, probes: bool = False,
                      on_divergence: str = "report", ragged: bool = False):
    """Returns ``multi_fn(state, staged, sched, sched_dev, root,
    start_event, n_events, hyper=None)`` -> ``(state, metrics)``, the
    events ``[start_event, start_event + n_events)`` of ``sched`` (an
    ``EventSchedule``; ``sched_dev`` its ``device_arrays``, of which the
    loop reads ``coeff``). ``state`` needs the carries of
    ``async_init_state``; ``hyper`` the sweepable scalars
    (``rounds.bind_hyper``). Metrics per event: ``loss`` (on the device),
    ``staleness``, ``applied`` and ``client`` (from the schedule), and with
    ``probes`` the (n_events, P) ``probes`` plane. ``on_divergence=
    "freeze"`` keeps the state an event held before a nonfinite update (the
    buffer's fill count follows the schedule).

    ``ragged`` (the streaming client plane): ``staged`` is the launch's
    event slab, one row per event of the window ({"x": (E, Lmax, ...),
    "y", "len"}, ``data/pipeline.SlabStager.event_slab``), read by
    ``gather_event_batch`` with the dense draw keyed by the schedule's
    client, so a ragged run is bitwise the dense one."""
    batch_size = batch_size or fl.batch_size
    steps = max(fl.local_steps, 1)
    fedbuff = max(fl.async_buffer, 1) > 1
    packed = strategy.packs_deltas
    packed_fedbuff = _packed_fedbuff(fl, strategy)
    freeze_div = probes and on_divergence == "freeze"

    def batch_of(staged, i: int, rkey: int, c: int):
        if ragged:
            row = {k: v[i] for k, v in staged.items()}
            b = gather_event_batch(row, rkey, c, batch_size, steps)
        else:
            b = gather_one_client_batch(staged, rkey, c, batch_size, steps)
        return {k: v[None] for k, v in b.items()}

    def multi_fn(state, staged, sched, sched_dev, root: int,
                 start_event: int, n_events: int, hyper=None):
        _, hyper = pop_alive(hyper)
        fl_h, strategy_h = bind_hyper(fl, strategy, hyper)
        st = dict(state)
        params, server, acc = st["params"], st["server"], st["acc"]
        # the ring and the int8 buffers are updated in place: copy them so
        # the caller's state stays as it was
        hist = {k: h.clone() for k, h in st["hist"].items()}
        if packed_fedbuff:
            qbuf, sbuf, cbuf = (st[k].clone() for k in ("qbuf", "sbuf", "cbuf"))
            bufn = _open_group(sched, start_event)
        dev = staged["x"].device
        losses, plane = [], []
        events = range(start_event, start_event + n_events)
        for i, e in enumerate(events):
            c = int(sched.client[e])
            rkey = determinism.round_key(root, int(sched.task[e]))
            stale = {k: h[int(sched.read_slot[e])] for k, h in hist.items()}
            cbatch = batch_of(staged, i, rkey, c)
            key = determinism.key_tensor(determinism.client_key(rkey, c), dev)
            delta, _, loss = local_train(model, strategy_h, fl_h, stale, server,
                                         (), cbatch, key, pack_deltas=packed)
            losses.append(loss[0])
            coeff = sched_dev["coeff"][e]
            apply = bool(sched.apply[e])
            old = (params, server, acc) + ((qbuf.clone(), sbuf.clone(), cbuf.clone())
                                           if packed_fedbuff and freeze_div else ())
            if packed_fedbuff:
                # the open group is buffered quantized; a rejected arrival
                # leaves its slot alone (accept, not coeff, which is 0 for
                # accepted zero-weight clients too, gates the write and count)
                if sched.accept[e]:
                    qbuf[bufn].copy_(delta.q[0])
                    sbuf[bufn].copy_(delta.scale[0])
                    cbuf[bufn].copy_(coeff)
                    bufn += 1
                if apply:
                    # the FedBuff flush: ONE fused dequant + weighted sum
                    agg = packing.unpack_tree(ops.quant_aggregate(qbuf, sbuf, cbuf),
                                              params)
            else:
                if packed:
                    # packed FedAsync: the event's int8 send dequantized and
                    # coeff-scaled by the kernel with C == 1
                    deq = packing.unpack_tree(ops.quant_aggregate(
                        delta.q, delta.scale, sched_dev["coeff"][e:e + 1]), params)
                    contrib = {k: coeff * (stale[k].to(torch.float32)
                                           - p.to(torch.float32)) + deq[k]
                               for k, p in params.items()}
                elif fedbuff:
                    contrib = {k: d[0] * coeff for k, d in delta.items()}
                else:
                    # FedAsync mixing: alpha * (client model - server)
                    # == alpha * ((stale - params) + delta)
                    contrib = {k: coeff * ((stale[k].to(torch.float32)
                                            - p.to(torch.float32)) + delta[k][0])
                               for k, p in params.items()}
                acc = tree_add(acc, contrib)
                if apply:
                    agg = acc
            new_params, keep = params, None
            if apply:
                agg = {k: a.to(params[k].dtype) for k, a in agg.items()}
                new_params, server = strategy_h.server_update(params, agg, server)
                if packed_fedbuff:
                    qbuf.zero_()
                    sbuf.zero_()
                    cbuf.zero_()
                    bufn = 0
                else:
                    acc = tree_zeros_like(acc)
            if probes:
                pr = _event_probes(new_params, old[0], stale,
                                   sched_dev["accept"][e].to(torch.float32),
                                   delta, packed, dev)
                plane.append(probelib.stack_probes(pr))
                if freeze_div:
                    keep = 1.0 - pr["nonfinite"]
                    new_params, server, acc = freeze_unless(
                        keep, (new_params, server, acc), old[:3])
                    if packed_fedbuff:
                        for buf, prev in zip((qbuf, sbuf, cbuf), old[3:]):
                            buf.copy_(torch.where(keep > 0, buf, prev))
            if apply:
                # a frozen event leaves the ring as it was
                w = int(sched.write_slot[e])
                for k, h in hist.items():
                    h[w].copy_(new_params[k] if keep is None
                               else torch.where(keep > 0, new_params[k], h[w]))
            params = new_params
        st.update(params=params, server=server, hist=hist, acc=acc)
        if packed_fedbuff:
            st.update(qbuf=qbuf, sbuf=sbuf, cbuf=cbuf,
                      bufn=torch.full((), bufn, dtype=torch.int32, device=dev))
        sl = slice(start_event, start_event + n_events)
        metrics = {"loss": torch.stack(losses),
                   "staleness": sched.staleness[sl].astype("float32"),
                   "applied": sched.apply[sl].astype("float32"),
                   "client": sched.client[sl].astype("float32")}
        if probes:
            metrics["probes"] = torch.stack(plane)
        return st, metrics

    return multi_fn


def _lane_events(scheds, lane_sched, e0: int, n: int, packed_fedbuff: bool,
                 device) -> dict:
    """The per-lane event fields of events [e0, e0 + n) as (S, n) device
    tensors, in one transfer, and ``any_apply`` (n,) on the host. ``row``:
    the FedBuff buffer row an accepted arrival writes (-1: none), from the
    schedule alone, as the single run's host count."""
    lanes = [scheds[u] for u in lane_sched]
    sl = slice(e0, e0 + n)
    f = {k: np.stack([getattr(sc, k)[sl] for sc in lanes])
         for k in ("client", "task", "read_slot", "write_slot", "accept",
                   "apply", "coeff")}
    if packed_fedbuff:
        rows = np.full((len(lanes), n), -1, np.int64)
        for s, sc in enumerate(lanes):
            bufn = _open_group(sc, e0)
            for i in range(n):
                if sc.accept[e0 + i]:
                    rows[s, i] = bufn
                    bufn += 1
                if sc.apply[e0 + i]:
                    bufn = 0
        f["row"] = rows
    any_apply = f["apply"].any(0)
    dev = {k: torch.as_tensor(v if k == "coeff" else v.astype(
        bool if k in ("accept", "apply") else np.int64), device=device)
        for k, v in f.items()}
    return dev, any_apply


def build_async_lanes(model, strategy: Strategy, fl: FLConfig,
                      batch_size=None, probes: bool = False,
                      on_divergence: str = "report"):
    """The campaign's async loop over S lanes. Returns ``lanes_fn(state,
    staged, scheds, lane_sched, roots, start_event, n_events, hyper)`` ->
    ``(state, metrics)``: ``state`` carries a leading S (the
    ``async_init_state`` carries too), ``staged`` per-lane ``idx``/``len``,
    ``scheds`` the unique ``EventSchedule``s and ``lane_sched`` each lane's
    index into them, ``roots`` (S,) int64, ``hyper`` (S,) scalars and
    optionally ``alive``. Metrics per event gain a leading S.

    Per event, one vmapped pass trains every lane's arriving client against
    its stale snapshot and folds the send in; at an event where any lane's
    schedule applies, a second pass computes every lane's flush and server
    update (int8 FedBuff: ONE ``ops.quant_aggregate`` launch over (S, K, N))
    and each lane keeps it where its own schedule applies. Lane s is bitwise
    the single run of its config (``build_async_multi``)."""
    batch_size = batch_size or fl.batch_size
    steps = max(fl.local_steps, 1)
    fedbuff = max(fl.async_buffer, 1) > 1
    packed = strategy.packs_deltas
    packed_fedbuff = _packed_fedbuff(fl, strategy)
    freeze_div = probes and on_divergence == "freeze"

    def arrive(st, staged, root, ev, hyper):
        """One lane: train the arrival, fold its send into the open group."""
        fl_h, strategy_h = bind_hyper(fl, strategy, hyper)
        params = st["params"]
        dev = staged["x"].device
        rkey = determinism.round_key(root, ev["task"])
        stale = {k: h[ev["read_slot"]] for k, h in st["hist"].items()}
        cbatch = {k: v[None] for k, v in gather_one_client_batch(
            staged, rkey, ev["client"], batch_size, steps).items()}
        key = determinism.key_tensor(determinism.client_key(rkey, ev["client"]), dev)
        delta, _, loss = local_train(model, strategy_h, fl_h, stale, st["server"],
                                     (), cbatch, key, pack_deltas=packed)
        coeff = ev["coeff"]
        out = dict(st)
        if packed_fedbuff:
            sel = torch.arange(fl.async_buffer, device=dev) == ev["row"]
            out["qbuf"] = torch.where(sel[:, None], delta.q, st["qbuf"])
            out["sbuf"] = torch.where(sel[:, None], delta.scale, st["sbuf"])
            out["cbuf"] = torch.where(sel, coeff, st["cbuf"])
        else:
            if packed:
                deq = packing.unpack_tree(ops.quant_aggregate(
                    delta.q, delta.scale, coeff.reshape(1)), params)
                contrib = {k: coeff * (stale[k].to(torch.float32)
                                       - p.to(torch.float32)) + deq[k]
                           for k, p in params.items()}
            elif fedbuff:
                contrib = {k: d[0] * coeff for k, d in delta.items()}
            else:
                contrib = {k: coeff * ((stale[k].to(torch.float32)
                                        - p.to(torch.float32)) + delta[k][0])
                           for k, p in params.items()}
            out["acc"] = tree_add(st["acc"], contrib)
        return out, loss[0], stale, delta

    def flush(st, ev, hyper):
        """One lane: the flush and server update, kept where it applies."""
        _, strategy_h = bind_hyper(fl, strategy, hyper)
        params = st["params"]
        if packed_fedbuff:
            agg = packing.unpack_tree(ops.quant_aggregate(
                st["qbuf"], st["sbuf"], st["cbuf"]), params)
        else:
            agg = st["acc"]
        agg = {k: a.to(params[k].dtype) for k, a in agg.items()}
        new_p, new_s = strategy_h.server_update(params, agg, st["server"])
        ring = next(iter(st["hist"].values())).shape[0]
        at = torch.arange(ring, device=ev["write_slot"].device) == ev["write_slot"]
        hist = {k: torch.where(at.reshape(-1, *([1] * new_p[k].dim())),
                               new_p[k][None], h) for k, h in st["hist"].items()}
        new = dict(st, params=new_p, server=new_s, hist=hist)
        if packed_fedbuff:
            new.update({k: torch.zeros_like(st[k]) for k in ("qbuf", "sbuf", "cbuf")})
        else:
            new["acc"] = tree_zeros_like(st["acc"])
        return freeze_unless(ev["apply"].to(torch.float32), new, st)

    def finish(prev, st, stale, delta, ev, alive):
        """One lane: probes, the divergence freeze and the alive mask."""
        pr = None
        if probes:
            pr = _event_probes(st["params"], prev["params"], stale,
                               ev["accept"].to(torch.float32), delta, packed,
                               ev["coeff"].device)
            if freeze_div:
                st = freeze_unless(1.0 - pr["nonfinite"], st, prev)
        if alive is not None:
            st = freeze_unless(alive, st, prev)
            if probes:
                pr = probelib.mask_probes(alive, pr)
        return st, (probelib.stack_probes(pr) if probes else ())

    arrive_v = vmap(arrive, in_dims=(0, DEDUP_STAGED_AXES, 0, 0, 0))
    flush_v = vmap(flush)

    def lanes_fn(state, staged, scheds, lane_sched, roots, start_event: int,
                 n_events: int, hyper):
        alive, hyper = pop_alive(hyper)
        dev = staged["x"].device
        evs, any_apply = _lane_events(scheds, lane_sched, start_event, n_events,
                                      packed_fedbuff, dev)
        finish_v = vmap(finish, in_dims=(0, 0, 0, 0, 0, None if alive is None else 0))
        st = state
        losses, plane = [], []
        for i in range(n_events):
            ev = {k: v[:, i] for k, v in evs.items()}
            prev = st
            st, loss, stale, delta = arrive_v(st, staged, roots, ev, hyper)
            if any_apply[i]:
                st = flush_v(st, ev, hyper)
            if probes or alive is not None:
                st, pr = finish_v(prev, st, stale, delta, ev, alive)
                plane.append(pr)
            losses.append(loss)
        sl = slice(start_event, start_event + n_events)
        lanes = [scheds[u] for u in lane_sched]
        metrics = {"loss": torch.stack(losses, 1)}
        metrics.update({k: np.stack([getattr(sc, k)[sl] for sc in lanes]).astype("float32")
                        for k in ("staleness", "client")})
        metrics["applied"] = np.stack([sc.apply[sl] for sc in lanes]).astype("float32")
        if probes:
            metrics["probes"] = torch.stack(plane, 1)
        if packed_fedbuff:
            # the open group's size, as the single run stores it
            st = dict(st, bufn=torch.tensor(
                [_open_group(sc, start_event + n_events) for sc in lanes],
                dtype=torch.int32, device=dev))
        return st, metrics

    return lanes_fn
