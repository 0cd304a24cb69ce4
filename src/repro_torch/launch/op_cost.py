"""Per-rank cost of a step, counted where its work is issued (port of
``repro/launch/hlo_cost.py``).

The JAX package compiles a step and walks the compiled HLO, whose shapes
are per device, multiplying while-loop bodies by their trip counts. The
port has no HLO to walk: a step is eager torch ops, c10d calls and
hand-written kernel launches, run by one rank of an SPMD program
(``launch/mesh.py``). So each is counted at its call site, as it runs,
and every count is this rank's:

- **torch ops**, by a ``TorchDispatchMode``: FLOPs by the formulas of
  ``torch.utils.flop_counter`` (matmuls, convolutions, attention), bytes as
  every op's operands plus its results. Nothing fuses in eager mode, so
  this is the counterpart of ``hbm_bytes``' as-compiled ceiling. Views and
  bare allocations move nothing and are left out, and so are the c10d ops
  (counted below). A loop runs as many times as it runs, so there is no
  trip count to multiply;
- **the kernels** B1-B4 record their own ``cost(...)`` where they launch
  (``record_kernel``): the dispatch mode sees the kernel's output
  allocated, not its work. Their meta branches record the same, so a run
  on the meta device and one on the card count alike;
- **the collectives** of ``sharding/axes`` record ``(kind, result bytes,
  group size)`` of each c10d call (``record_collective``), the backwards'
  too, in the JAX package's five kinds, with its per-chip traffic formulas
  (``traffic``). A permute records the bytes this rank sends: a rank at the
  edge of a permutation sends nothing, so ranks can differ in permute
  traffic, which the JAX package's SPMD HLO counts the same on every chip.

Outside ``cost_scope()`` nothing is counted and nothing is slowed: the
records are a list check.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch.utils._pytree import tree_leaves

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# ops that allocate without reading or writing a byte
_ALLOCATIONS = frozenset({"empty", "empty_like", "new_empty", "empty_strided",
                          "new_empty_strided", "empty_permuted"})
_UNCOUNTED_NAMESPACES = frozenset({"c10d", "_c10d_functional"})
_SCOPES: list = []


def traffic(kind: str, result_bytes: float, g: int) -> float:
    """Per-chip link bytes of one collective of ``kind`` with a result of
    ``result_bytes`` over a group of ``g`` (the JAX package's formulas):
    all-gather and all-to-all r(g-1)/g, all-reduce 2r(g-1)/g,
    reduce-scatter r(g-1), permute r."""
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (g - 1) / g
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective kind {kind!r}; one of {KINDS}")


def _kinds(value):
    return {k: value for k in KINDS}


@dataclasses.dataclass
class Cost:
    """One rank's counts: ``flops`` and ``hbm_bytes`` of its torch ops and
    kernels; per collective kind, its ``coll_counts``, ``coll_result_bytes``
    and ``coll_traffic``; ``calls``, every collective as ``(kind, result
    bytes, group size)`` in the order issued; ``by_kernel``, per kernel
    name, its ``launches``, ``flops``, ``bytes`` and launches ``by_shape``
    (a shape key as the kernel's ``launches_by_shape`` keys it, joined by
    commas)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_traffic: dict = dataclasses.field(default_factory=lambda: _kinds(0.0))
    coll_counts: dict = dataclasses.field(default_factory=lambda: _kinds(0))
    coll_result_bytes: dict = dataclasses.field(default_factory=lambda: _kinds(0))
    calls: list = dataclasses.field(default_factory=list)
    by_kernel: dict = dataclasses.field(default_factory=dict)

    def scaled(self, k: float) -> "Cost":
        """Every count times ``k`` (``calls`` dropped: a sequence does not
        scale)."""
        return Cost(self.flops * k, self.hbm_bytes * k,
                    {a: v * k for a, v in self.coll_traffic.items()},
                    {a: v * k for a, v in self.coll_counts.items()},
                    {a: v * k for a, v in self.coll_result_bytes.items()}, [],
                    {n: {"launches": e["launches"] * k, "flops": e["flops"] * k,
                         "bytes": e["bytes"] * k,
                         "by_shape": {s: c * k for s, c in e["by_shape"].items()}}
                     for n, e in self.by_kernel.items()})

    def add(self, o: "Cost") -> "Cost":
        """Add ``o``'s counts to this one's, in place; returns self."""
        self.flops += o.flops
        self.hbm_bytes += o.hbm_bytes
        for a in KINDS:
            self.coll_traffic[a] += o.coll_traffic[a]
            self.coll_counts[a] += o.coll_counts[a]
            self.coll_result_bytes[a] += o.coll_result_bytes[a]
        self.calls.extend(o.calls)
        for name, e in o.by_kernel.items():
            mine = self.by_kernel.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0,
                                                    "by_shape": {}})
            for f in ("launches", "flops", "bytes"):
                mine[f] += e[f]
            for s, c in e["by_shape"].items():
                mine["by_shape"][s] = mine["by_shape"].get(s, 0) + c
        return self


def active() -> bool:
    """Whether a ``cost_scope`` is open."""
    return bool(_SCOPES)


def record_collective(kind: str, result_bytes: int, g: int) -> None:
    """One c10d call of ``kind`` with a result of ``result_bytes`` (a
    permute: the bytes this rank sends) over a group of ``g``, into every
    open scope."""
    for c in _SCOPES:
        c.coll_counts[kind] += 1
        c.coll_result_bytes[kind] += result_bytes
        c.coll_traffic[kind] += traffic(kind, result_bytes, g)
        c.calls.append((kind, int(result_bytes), int(g)))


def record_kernel(name: str, key: tuple, flops: float, nbytes: float) -> None:
    """One launch of kernel ``name`` at shape ``key``, of ``flops``
    operations and ``nbytes`` bytes (its module's ``cost``), into every
    open scope."""
    shape = ",".join(str(int(k)) for k in key)
    for c in _SCOPES:
        e = c.by_kernel.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0,
                                          "by_shape": {}})
        e["launches"] += 1
        e["flops"] += flops
        e["bytes"] += nbytes
        e["by_shape"][shape] = e["by_shape"].get(shape, 0) + 1
        c.flops += flops
        c.hbm_bytes += nbytes


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


class _OpCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """FLOPs and operand + result bytes of every torch op into ``cost``."""

    def __init__(self, cost: Cost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet not in flop_registry:
            # a composite op (``matmul`` under inference mode, say) counts as
            # the ops it is made of, as ``FlopCounterMode`` counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if func.namespace in _UNCOUNTED_NAMESPACES or func.is_view or \
                packet.__name__ in _ALLOCATIONS:
            return out
        if packet in flop_registry:
            self.cost.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.cost.hbm_bytes += _nbytes(tree_leaves((args, kwargs))) + _nbytes(tree_leaves(out))
        return out


@contextlib.contextmanager
def cost_scope():
    """Count what runs inside the block; yields the live ``Cost``. Scopes
    nest: an inner scope's records reach the outer ones too."""
    cost = Cost()
    _SCOPES.append(cost)
    try:
        with _OpCounter(cost):     # an outer scope's mode sees the ops too
            yield cost
    finally:
        _SCOPES.remove(cost)
