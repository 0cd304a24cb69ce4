"""Event-driven asynchronous FL servers, FedAsync and FedBuff (port of
``repro/core/async_rounds.py``).

The loop runs over *server events*, one completed client task each, in the
order of the virtual clock (``runtime/clock.build_schedule``). The schedule
is numpy on the host, so every branch (apply or not, accepted or not, which
ring slot) is a host ``if`` and no event waits for the device. Per event:

1. the arriving client's batch is gathered from the partitions staged on the
   device (``data/pipeline.gather_one_client_batch``: bitwise lane ``c`` of
   the sync driver's gather, keyed by (root, task index, client));
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
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import determinism, packing
from repro_torch.core.rounds import local_train
from repro_torch.core.strategy import Strategy, tree_add, tree_zeros_like
from repro_torch.data.pipeline import gather_one_client_batch
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


def build_async_multi(model, strategy: Strategy, fl: FLConfig,
                      batch_size=None):
    """Returns ``multi_fn(state, staged, sched, sched_dev, root,
    start_event, n_events)`` -> ``(state, metrics)``, the events
    ``[start_event, start_event + n_events)`` of ``sched`` (an
    ``EventSchedule``; ``sched_dev`` its ``device_arrays``, of which the
    loop reads ``coeff``). ``state`` needs the carries of
    ``async_init_state``. Metrics per event: ``loss`` (on the device),
    ``staleness``, ``applied`` and ``client`` (from the schedule)."""
    batch_size = batch_size or fl.batch_size
    steps = max(fl.local_steps, 1)
    fedbuff = max(fl.async_buffer, 1) > 1
    packed = strategy.packs_deltas
    packed_fedbuff = _packed_fedbuff(fl, strategy)

    def multi_fn(state, staged, sched, sched_dev, root: int,
                 start_event: int, n_events: int):
        st = dict(state)
        params, server, acc = st["params"], st["server"], st["acc"]
        # the ring and the int8 buffers are updated in place: copy them so
        # the caller's state stays as it was
        hist = {k: h.clone() for k, h in st["hist"].items()}
        if packed_fedbuff:
            qbuf, sbuf, cbuf = (st[k].clone() for k in ("qbuf", "sbuf", "cbuf"))
            bufn = _open_group(sched, start_event)
        dev = staged["x"].device
        losses = []
        events = range(start_event, start_event + n_events)
        for e in events:
            c = int(sched.client[e])
            rkey = determinism.round_key(root, int(sched.task[e]))
            stale = {k: h[int(sched.read_slot[e])] for k, h in hist.items()}
            cbatch = {k: v[None] for k, v in gather_one_client_batch(
                staged, rkey, c, batch_size, steps).items()}
            key = determinism.key_tensor(determinism.client_key(rkey, c), dev)
            delta, _, loss = local_train(model, strategy, fl, stale, server,
                                         (), cbatch, key, pack_deltas=packed)
            losses.append(loss[0])
            coeff = sched_dev["coeff"][e]
            apply = bool(sched.apply[e])
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
            if apply:
                agg = {k: a.to(params[k].dtype) for k, a in agg.items()}
                params, server = strategy.server_update(params, agg, server)
                w = int(sched.write_slot[e])
                for k, h in hist.items():
                    h[w].copy_(params[k])
                if packed_fedbuff:
                    qbuf.zero_()
                    sbuf.zero_()
                    cbuf.zero_()
                    bufn = 0
                else:
                    acc = tree_zeros_like(acc)
        st.update(params=params, server=server, hist=hist, acc=acc)
        if packed_fedbuff:
            st.update(qbuf=qbuf, sbuf=sbuf, cbuf=cbuf,
                      bufn=torch.full((), bufn, dtype=torch.int32, device=dev))
        sl = slice(start_event, start_event + n_events)
        return st, {"loss": torch.stack(losses),
                    "staleness": sched.staleness[sl].astype("float32"),
                    "applied": sched.apply[sl].astype("float32"),
                    "client": sched.client[sl].astype("float32")}

    return multi_fn
