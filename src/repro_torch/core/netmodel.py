"""Wire-level network model: payload bytes, link plans, simulated time
(port of ``repro/core/netmodel.py``).

The comms observatory (``telemetry/comms.py``) needs three pure-host
ingredients, all collected here so the byte-accounting rules live in one
place and stay testable without an executor:

1. **Payload sizes** — how many bytes one client exchange costs, from the
   actual representations the round loops move: dense f32 state/deltas, the
   packed int8 ``PackedDelta`` (``packing.packed_nbytes``: 1 byte/value +
   4 bytes/block scale), topk sparse sends ((int32 index, f32 value) pairs),
   consensus digest votes (``consensus.digest_nbytes``) and full f32
   worker-aggregate sharing, gossip neighbour exchanges
   (``topology.GOSSIP_NEIGHBORS`` sends per client per step), hierarchical
   edge->cloud backbone hops, and blockchain block records.

2. **LinkModel draws** — per-client up/down bandwidth and latency from the
   ``ClientSystemModel`` link fields. Tier assignment comes from the
   ``clock._TAG_LINK`` Philox stream: a *new* tag, so link draws never
   perturb the rate/jitter/straggler/availability columns — schedules are
   bitwise identical with the link model on or off, and prefix-stable in
   the number of clients drawn.

3. **Simulated wall-clock** — ``LaneComms`` composes transfer time with the
   virtual clock's compute durations (``clock._dur_column``, the same
   per-task streams the async schedule consumed):

   - sync round makespan = max over the kept cohort of
     (downlink + compute + uplink) + aggregation hop (one extra latency per
     tier past the server: hierarchical backbone, consensus exchange);
   - async reuses ``EventSchedule.vtime`` shifted per event by the client's
     cumulative transfer time ((task+1) round-trips), folded monotone by a
     running max.

   On the FedAvg-identity configuration (equal speeds, FedBuff buffer ==
   cohort) the two compositions agree — the same collapse the schedule
   itself guarantees for params (tests/test_torch_comms.py).

Everything here is host-side numpy over shapes and schedule arrays — zero
device code, so comms accounting can never perturb a trajectory. A param
tree's leaves are taken in the port's sorted-key order, which is
``jax.tree.leaves`` order. The sync participation replay is the port's own
``runtime/faults.cohort_mask``, the mask the port's round applies; it draws
other cohorts than the JAX package's, so the two packages' byte counts
agree only where the mask keeps every client.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.checkpoint.ckpt import leaves
from repro_torch.configs.base import FLConfig
from repro_torch.core.consensus import digest_nbytes
from repro_torch.core.packing import QBLOCK, packed_nbytes
from repro_torch.core.topology import GOSSIP_NEIGHBORS
from repro_torch.runtime.clock import (ClientSystemModel, _TAG_LINK, _column,
                                       _dur_column, client_rates)
from repro_torch.runtime.faults import cohort_mask

# one blockchain block record per round when a ledger is configured: the
# SHA256 param digest that crosses the simulated network (provenance is
# per-round by construction, so byte totals stay chunking-invariant even
# though the host ledger batches its writes at chunk boundaries)
BLOCK_NBYTES = 32


# ---------------------------------------------------------------------------
# payload sizes (pure functions of the param-tree shapes + FLConfig)
# ---------------------------------------------------------------------------

class _ShapeLeaf:
    """Shape-only stand-in leaf: everything the size helpers read
    (``.shape`` / ``.size``) without holding device memory."""
    __slots__ = ("shape", "size")

    def __init__(self, shape):
        self.shape = tuple(shape)
        self.size = int(math.prod(self.shape)) if self.shape else 1

    def numel(self) -> int:
        """Element count, as a tensor's (``packing.packed_nbytes`` reads it)."""
        return self.size


def shape_template(tree, strip_leading: bool = False) -> list:
    """Shape-only copy of a param tree (a flat leaf list). The byte model
    prices ONE model's exchange: decentralized states strip the per-client
    dim via ``strip_leading``."""
    return [_ShapeLeaf(leaf.shape[1:] if strip_leading else leaf.shape)
            for leaf in leaves(tree)]


def tree_sizes(template) -> list:
    """Per-leaf element counts of a param pytree (shape-only)."""
    return [int(math.prod(leaf.shape)) if leaf.shape else 1
            for leaf in leaves(template)]


def dense_nbytes(template) -> int:
    """Bytes of one dense f32 send of the whole tree (state or delta —
    every round loop casts deltas to f32 before they cross the network)."""
    return 4 * sum(tree_sizes(template))


def topk_nbytes(template, topk_ratio: float) -> int:
    """Bytes of one topk sparse send: k (int32 index, f32 value) pairs."""
    n = sum(tree_sizes(template))
    k = max(int(math.ceil(float(topk_ratio) * n)), 1)
    return 8 * k


def uplink_nbytes(template, fl: FLConfig) -> int:
    """Bytes of one client's *uplink* payload under ``fl.compression``."""
    if fl.compression == "int8":
        # packed_nbytes walks a dict's leaves in key order: number them
        return packed_nbytes(dict(enumerate(_ShapeLeaf(leaf.shape)
                                            for leaf in leaves(template))),
                             QBLOCK)
    if fl.compression == "topk":
        return topk_nbytes(template, fl.topk_ratio)
    return dense_nbytes(template)


def payload_nbytes(template, fl: FLConfig) -> tuple:
    """(uplink, downlink) bytes of one client's round exchange. Downlink is
    the dense f32 global state (the server broadcasts uncompressed)."""
    return uplink_nbytes(template, fl), dense_nbytes(template)


# ---------------------------------------------------------------------------
# topology traffic matrices
# ---------------------------------------------------------------------------

def gossip_matrix(n_clients: int, state_nbytes: int,
                  gossip_steps: int = 1) -> np.ndarray:
    """(C, C) bytes sent i -> j over one round of decentralized gossip.

    The meshless ring mixes each client with its ±1 neighbours
    (``GOSSIP_NEIGHBORS`` sends per step), so the matrix is symmetric —
    every i -> j send has the j -> i reciprocal — and scales linearly with
    ``gossip_steps`` (the satellite invariants in tests/test_comms.py)."""
    C = int(n_clients)
    m = np.zeros((C, C), np.int64)
    if C < 2:
        return m
    per = int(state_nbytes) * int(gossip_steps)
    for i in range(C):
        m[i, (i + 1) % C] += per
        m[i, (i - 1) % C] += per
    return m


def hierarchical_nbytes(intra_up: int, intra_down: int, state_nbytes: int,
                        pods: int = 1) -> tuple:
    """(intra_pod, cross_pod) byte split of one hierarchical round: clients
    talk to their pod's edge aggregator (the client_server bytes), then each
    pod ships its f32 edge aggregate to the cloud and receives the global
    state back — two backbone hops per pod."""
    cross = 2 * int(pods) * int(state_nbytes)
    return int(intra_up) + int(intra_down), cross


def consensus_nbytes(fl: FLConfig, state_nbytes: int) -> int:
    """Multi-worker consensus overlay bytes per round: phase-1 full f32
    aggregate sharing (all-to-all among W workers) + phase-2 digest votes."""
    w = max(int(fl.n_workers), 1)
    if w <= 1:
        return 0
    share = w * (w - 1) * int(state_nbytes)
    votes = w * (w - 1) * digest_nbytes()
    return share + votes


def round_nbytes(template, fl: FLConfig, pods: int = 1) -> int:
    """Total wire bytes of one full-participation round, in closed form
    (masked accounting lives in ``LaneComms``)."""
    sb = dense_nbytes(template)
    C = int(fl.n_clients)
    cohort = int(fl.cohort or C)
    ledger = BLOCK_NBYTES if fl.blockchain != "none" else 0
    if fl.topology == "decentralized":
        per = GOSSIP_NEIGHBORS * int(fl.gossip_steps) * sb
        return C * per * 2 + ledger          # every send is a receive
    up, down = payload_nbytes(template, fl)
    total = cohort * (up + down) + consensus_nbytes(fl, sb) + ledger
    if fl.topology == "hierarchical":
        total += hierarchical_nbytes(0, 0, sb, pods)[1]
    return total


# ---------------------------------------------------------------------------
# LinkModel: per-client bandwidth/latency draws
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LinkPlan:
    """Materialized per-client link parameters (bytes/virtual-second)."""
    up_Bps: np.ndarray        # (C,) f64
    down_Bps: np.ndarray      # (C,) f64
    latency_s: float

    def up_time(self, nbytes) -> np.ndarray:
        """Per-client uplink transfer seconds for an ``nbytes`` payload."""
        return self.latency_s + np.asarray(nbytes, np.float64) / self.up_Bps

    def down_time(self, nbytes) -> np.ndarray:
        """Per-client downlink transfer seconds for an ``nbytes`` payload."""
        return self.latency_s + np.asarray(nbytes, np.float64) \
            / self.down_Bps


def client_links(csm: ClientSystemModel, n_clients: int) -> LinkPlan:
    """Draw the per-client link plan from the ``_TAG_LINK`` Philox stream.

    Tier t (0 = top) scales both directions by ``link_tier_factor ** t``;
    ``link_tiers == 1`` skips the draw entirely (homogeneous links). Seeded
    like every other client-system stream, so the plan is seed-pure and
    prefix-stable in ``n_clients``."""
    C = int(n_clients)
    tiers = max(int(getattr(csm, "link_tiers", 1)), 1)
    if tiers > 1:
        tier = _column(csm.seed, _TAG_LINK, 0,
                       lambda g, n: g.integers(0, tiers, n), C)
    else:
        tier = np.zeros(C, np.int64)
    factor = float(getattr(csm, "link_tier_factor", 0.5)) ** \
        tier.astype(np.float64)
    up = float(getattr(csm, "up_mbps", 100.0)) * 1e6 / 8.0 * factor
    down = float(getattr(csm, "down_mbps", 400.0)) * 1e6 / 8.0 * factor
    return LinkPlan(up_Bps=np.maximum(up, 1.0),
                    down_Bps=np.maximum(down, 1.0),
                    latency_s=float(getattr(csm, "latency_s", 0.01)))


# ---------------------------------------------------------------------------
# LaneComms: one lane's running traffic + simulated-clock accountant
# ---------------------------------------------------------------------------

# per-round columns every accountant emits (comms.csv schema, sorted into
# the tidy rows by the executor)
COMMS_COLUMNS = ("up_bytes", "down_bytes", "overlay_bytes", "makespan_s",
                 "cum_up_bytes", "cum_down_bytes", "cum_bytes", "sim_time_s")


@dataclasses.dataclass
class LaneComms:
    """Running wire-traffic + simulated wall-clock accountant for one lane.

    Stateful on purpose: cumulative counters advance strictly in round
    order, once per round, independent of how the chunk loop slices the
    horizon — which is what makes byte totals chunking-invariant (chunk=1
    == chunk=3, asserted in tests/test_torch_comms.py). The sync path
    replays the round's cohort mask on the host (``faults.cohort_mask``,
    the very function the sync round loop calls); the async path reads the
    precomputed schedule's accept flags — so byte counts are gated by
    exactly the participation the round loops computed.
    """
    fl: FLConfig
    csm: ClientSystemModel
    template: object          # param pytree (shape-only use)
    pods: int = 1

    def __post_init__(self):
        fl, C = self.fl, int(self.fl.n_clients)
        if not isinstance(self.csm, ClientSystemModel):
            self.csm = ClientSystemModel(**dataclasses.asdict(self.csm))
        self.links = client_links(self.csm, C)
        self.rate = client_rates(self.csm, C)
        self.state_nbytes = dense_nbytes(self.template)
        self.up_payload, self.down_payload = payload_nbytes(self.template,
                                                            fl)
        self._target = int(fl.cohort or C)
        # full-participation fast path: with the whole population kept and
        # no drops the in-program mask is all-ones (rank < target keeps
        # every eligible client), so the per-round replay can be skipped
        self._trivial_mask = (self._target >= C
                              and self.csm.drop_prob == 0.0)
        self.cum_up = 0
        self.cum_down = 0
        self.cum_overlay = 0
        self.cum_dense_up = 0     # uncompressed-equivalent uplink (ratio)
        self.sim_time = 0.0
        # decentralized per-client gossip bytes per round (each client
        # sends its state to GOSSIP_NEIGHBORS peers per step — and receives
        # symmetrically, per the gossip_matrix invariant)
        self._gossip_per_client = (GOSSIP_NEIGHBORS * int(fl.gossip_steps)
                                   * self.state_nbytes)
        # round-invariant pieces, hoisted out of the per-round loop (the
        # accountant runs at every chunk boundary — at chunk=1 this is the
        # BENCH_comms overhead budget): per-client link transfer time, the
        # aggregation hop, the ledger record, the per-round overlay, and
        # the decentralized per-step transfer time
        self._ledger_nbytes = (BLOCK_NBYTES if fl.blockchain != "none"
                               else 0)
        self._t_link = (self.links.down_time(self.down_payload)
                        + self.links.up_time(self.up_payload))
        self._hop_s = self._agg_hop_s()
        self._overlay = consensus_nbytes(fl, self.state_nbytes) \
            + self._ledger_nbytes
        if fl.topology == "hierarchical":
            self._overlay += hierarchical_nbytes(
                0, 0, self.state_nbytes, self.pods)[1]
        self._gossip_step_s = (
            self._gossip_per_client / self.links.up_Bps
            + self._gossip_per_client / self.links.down_Bps
            + 2.0 * self.links.latency_s)

    # -- participation replay ---------------------------------------------
    def _kept(self, r: int) -> np.ndarray:
        """(C,) bool: the round's kept cohort, bitwise the mask
        ``rounds.build_multi_round`` draws from the same fault model."""
        C = int(self.fl.n_clients)
        if self._trivial_mask:
            return np.ones(C, bool)
        m = cohort_mask(self.csm, r, C, self._target,
                        self.fl.straggler_overprovision)
        return m > 0

    def _agg_hop_s(self) -> float:
        """Extra aggregation-hop latency past the plain server reduce: one
        per backbone tier (hierarchical) and one per consensus exchange.
        Zero for single-worker client_server — which is what lets the sync
        makespan agree exactly with the shifted async vtime on the
        FedAvg-identity configuration."""
        hop = 0.0
        if self.fl.topology == "hierarchical":
            hop += self.links.latency_s
        if max(int(self.fl.n_workers), 1) > 1:
            hop += self.links.latency_s
        return hop

    # -- sync rounds -------------------------------------------------------
    def sync_rounds(self, start: int, n: int) -> dict:
        """Account rounds [start, start+n): per-round byte totals and the
        simulated makespan, plus the running cumulative columns."""
        fl = self.fl
        C = int(fl.n_clients)
        out = {k: np.zeros(n, np.float64) for k in COMMS_COLUMNS}
        for i in range(n):
            r = start + i
            dur = _dur_column(self.csm, self.rate, r).astype(np.float64)
            if fl.topology == "decentralized":
                # no server: every client gossips regardless of the weight
                # mask (the mix ignores aggregation weights)
                up = C * self._gossip_per_client
                down = up                      # each send is a receive
                dense_up = up
                overlay = self._ledger_nbytes
                makespan = float((dur + self._gossip_step_s).max())
            elif self._trivial_mask:
                up = C * self.up_payload
                down = C * self.down_payload
                dense_up = C * self.state_nbytes
                overlay = self._overlay
                makespan = float((dur + self._t_link).max()) + self._hop_s
            else:
                kept = self._kept(r)
                k = int(kept.sum())
                up = k * self.up_payload
                down = k * self.down_payload
                dense_up = k * self.state_nbytes
                overlay = self._overlay
                if k:
                    t_c = dur + self._t_link
                    makespan = float(t_c[kept].max()) + self._hop_s
                else:
                    makespan = 0.0
            self._advance(out, i, up, down, overlay, dense_up,
                          self.sim_time + makespan)
        return out

    # -- async event windows ----------------------------------------------
    def async_rounds(self, start: int, n: int, schedule,
                     events_per_round: int) -> dict:
        """Account async "rounds" (fixed event windows): downlink per
        dispatched task, uplink only for *accepted* arrivals (a rejected
        arrival's bytes never reach the aggregation path — the zero-uplink
        invariant), simulated time = ``vtime`` shifted by each client's
        cumulative transfer time, folded monotone by a running max."""
        epr = int(events_per_round)
        e0 = start * epr
        out = {k: np.zeros(n, np.float64) for k in COMMS_COLUMNS}
        cli = np.asarray(schedule.client[e0:e0 + n * epr])
        task = np.asarray(schedule.task[e0:e0 + n * epr], np.float64)
        acc = np.asarray(schedule.accept[e0:e0 + n * epr], bool)
        vt = np.asarray(schedule.vtime[e0:e0 + n * epr], np.float64)
        up_t = self.links.up_time(self.up_payload)      # (C,)
        down_t = self.links.down_time(self.down_payload)
        w = vt + (task + 1.0) * (up_t[cli] + down_t[cli])
        for i in range(n):
            sl = slice(i * epr, (i + 1) * epr)
            up = int(acc[sl].sum()) * self.up_payload
            dense_up = int(acc[sl].sum()) * self.state_nbytes
            down = epr * self.down_payload
            t = max(self.sim_time, float(w[sl].max()))
            self._advance(out, i, up, down, 0, dense_up, t)
        return out

    def frozen(self, n: int) -> dict:
        """A dead campaign lane's columns: zero per-round traffic,
        cumulative counters held at their freeze values."""
        out = {k: np.zeros(n, np.float64) for k in COMMS_COLUMNS}
        out["cum_up_bytes"][:] = self.cum_up
        out["cum_down_bytes"][:] = self.cum_down
        out["cum_bytes"][:] = self.cum_up + self.cum_down + self.cum_overlay
        out["sim_time_s"][:] = self.sim_time
        return out

    def _advance(self, out: dict, i: int, up: int, down: int, overlay: int,
                 dense_up: int, sim_time: float):
        self.cum_up += int(up)
        self.cum_down += int(down)
        self.cum_overlay += int(overlay)
        self.cum_dense_up += int(dense_up)
        makespan = sim_time - self.sim_time
        self.sim_time = float(sim_time)
        out["up_bytes"][i] = up
        out["down_bytes"][i] = down
        out["overlay_bytes"][i] = overlay
        out["makespan_s"][i] = makespan
        out["cum_up_bytes"][i] = self.cum_up
        out["cum_down_bytes"][i] = self.cum_down
        out["cum_bytes"][i] = self.cum_up + self.cum_down + self.cum_overlay
        out["sim_time_s"][i] = self.sim_time

    def summary(self) -> dict:
        """Run-level totals: cumulative per-direction bytes, the
        dense-equivalent uplink (the compression-ratio denominator), and
        the simulated wall-clock."""
        return {"up_bytes": int(self.cum_up),
                "down_bytes": int(self.cum_down),
                "overlay_bytes": int(self.cum_overlay),
                "dense_up_bytes": int(self.cum_dense_up),
                "sim_time_s": float(self.sim_time)}
