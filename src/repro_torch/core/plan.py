"""Campaign planner (port of ``repro/core/plan.py``): heterogeneous sweeps
via program-signature buckets.

Every trajectory of an expanded grid gets a **program signature** — the
canonical tuple of everything that changes the round program (strategy
kind, topology, placement, sync/async loop shape, cohort/steps shapes, ring
size, ...) and nothing that doesn't (scalar-plane knobs, data-plane seeds
and alphas, schedule-plane exponents). Lanes bucket by signature, and each
bucket runs as one ``CampaignExecutor`` (``runtime/scheduler.PlanExecutor``
drives the buckets in lockstep). The signature's fields are the JAX
package's, so both packages put the same job into the same buckets.

Canonicalization is where buckets merge: ``placement: auto`` resolves to
``spatial``; sync signatures ignore async-only knobs and async ones
sync-only knobs; ``async_buffer`` 0 and 1 are both FedAsync.

Determinism contract (``tests/test_torch_plan.py``): with the lane
scheduler off, every lane of a heterogeneous campaign is bitwise its
independent single run — the planner only decides which lanes share a
launch, never what they compute.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

from repro_torch.configs.base import FLConfig
from repro_torch.core.sweeps import SweepSpec, expand


def resolve_placement(fl: FLConfig) -> str:
    """The executor's placement resolution (``auto`` -> ``spatial``)."""
    return fl.placement if fl.placement != "auto" else "spatial"


def program_signature(fl: FLConfig, arch: str = "") -> Tuple:
    """Canonical key of the traced round/event program for ``fl``.

    Two configs get equal signatures iff the compiled program that executes
    them is structurally identical, so their trajectories can share one
    vmapped launch. Includes everything trace-shaping: mode and its loop
    shape, strategy kind, client/cohort/step counts, optimizer structure,
    compression, consensus, and (sync) topology/placement or (async) the
    event-loop shape. Excludes the scalar plane (traced runtime values),
    the data plane (seed, alpha, partition) and the schedule plane
    (staleness_exponent, concurrency — host-precomputed arrays).
    """
    mode = fl.mode
    target = int(fl.cohort or fl.n_clients)
    sig: Dict[str, Any] = {
        "arch": arch,
        "mode": mode,
        "strategy": fl.strategy,
        "local_epochs": fl.local_epochs,
        "local_steps": max(fl.local_steps, 1),
        "batch_size": fl.batch_size,
        "client_optimizer": fl.client_optimizer,
        # local_train's momentum carry only exists under sgdm with beta>0
        "client_momentum": (fl.client_momentum
                            if fl.client_optimizer == "sgdm" else 0.0),
        "server_optimizer": fl.server_optimizer,
        "compression": fl.compression,
        "topk_ratio": (fl.topk_ratio if fl.compression == "topk" else 0.0),
        "error_feedback": (fl.error_feedback
                           if fl.compression != "none" else True),
        "n_workers": fl.n_workers,
        "byzantine_workers": fl.byzantine_workers,
        "consensus": (fl.consensus if (fl.n_workers > 1
                                       or fl.byzantine_workers > 0) else ""),
    }
    if fl.max_cohort > 0:
        # ragged client plane: the cohort is padded to max_cohort slots and
        # the draw happens on the host (data/pipeline.SlabStager), so the
        # population and cohort sizes never reach the trace — sweeping
        # n_clients/cohort shares one program instead of splitting buckets
        # (fl.streaming is deliberately absent: the staging backend feeds
        # the same compiled program, that is the bitwise contract)
        sig["ragged_slots"] = int(fl.max_cohort)
    else:
        sig["n_clients"] = fl.n_clients
        sig["cohort"] = target
        # the over-provisioned pool size is a Python int inside cohort_mask
        sig["cohort_pool"] = int(min(
            math.ceil(target * fl.straggler_overprovision), fl.n_clients))
    if mode == "sync":
        # async-only knobs don't reach the sync trace; zeroing them merges
        # buckets that would otherwise split spuriously
        sig["topology"] = fl.topology
        sig["placement"] = resolve_placement(fl)
        sig["gossip_steps"] = (fl.gossip_steps
                               if fl.topology == "decentralized" else 0)
    else:
        # the event loop has no topology/placement; its shape is the
        # FedAsync/FedBuff branch, the events-per-round chunking unit, and
        # the snapshot-ring size
        fedbuff = max(fl.async_buffer, 1) > 1
        sig["fedbuff"] = fedbuff
        sig["events_per_round"] = (fl.async_buffer if fedbuff
                                   else fl.n_clients)
        sig["ring"] = int(fl.max_staleness) + 1
    return tuple(sorted(sig.items()))


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One program signature's worth of lanes (a homogeneous sub-campaign)."""
    index: int
    signature: Tuple
    lane_ids: Tuple[int, ...]          # global lane indices into the grid
    coords: Tuple[Dict[str, Any], ...]
    fls: Tuple[FLConfig, ...]

    @property
    def size(self) -> int:
        """Number of trajectories in this bucket."""
        return len(self.lane_ids)


@dataclasses.dataclass(frozen=True)
class CampaignPlan:
    """The expanded grid, partitioned into signature buckets."""
    spec: SweepSpec
    coords: Tuple[Dict[str, Any], ...]  # row-major, global lane order
    fls: Tuple[FLConfig, ...]
    signatures: Tuple[Tuple, ...]       # per-lane, parallel to coords
    buckets: Tuple[Bucket, ...]         # first-appearance order

    @property
    def size(self) -> int:
        """Total trajectories across all buckets."""
        return len(self.coords)

    def lane_bucket(self, lane: int) -> Tuple[int, int]:
        """(bucket index, index within the bucket) of a global lane id."""
        for b in self.buckets:
            if lane in b.lane_ids:
                return b.index, b.lane_ids.index(lane)
        raise KeyError(f"lane {lane} not in any bucket (grid has "
                       f"{self.size} lanes)")


def build_plan(fl: FLConfig, spec: SweepSpec, arch: str = "") -> CampaignPlan:
    """Expand the grid and bucket the lanes by program signature.

    Pure bookkeeping: lanes keep their row-major global ids, buckets are
    ordered by first appearance, and within a bucket lanes keep grid order —
    so bucket lane ``j`` is always a deterministic function of the spec.
    """
    coords = spec.coords()
    fls = expand(fl, spec)
    sigs = [program_signature(fl_s, arch) for fl_s in fls]
    groups: Dict[Tuple, List[int]] = {}
    for lane, sig in enumerate(sigs):
        groups.setdefault(sig, []).append(lane)
    buckets = tuple(
        Bucket(index=b, signature=sig, lane_ids=tuple(lanes),
               coords=tuple(coords[i] for i in lanes),
               fls=tuple(fls[i] for i in lanes))
        for b, (sig, lanes) in enumerate(groups.items()))
    return CampaignPlan(spec=spec, coords=tuple(coords), fls=tuple(fls),
                        signatures=tuple(sigs), buckets=buckets)
